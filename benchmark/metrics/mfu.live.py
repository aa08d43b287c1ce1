"""The whole live hop's share of the card's dense bf16 peak, in %: the FLOPs
that the configuration's model needs for every stream's hops completed in
the untraced window (its ``flops_per_hop``, counted from shapes) over the
window's seconds. Read only where the run drove a card."""

from benchmark.harness import PEAKS


def read(sl):
    if not sl.device:
        return None
    flops = sl.run_calls * sl.traffic["streams"] * sl.config.module.flops_per_hop(sl.config.data)
    return 100.0 * flops / sl.run_window_s / PEAKS["bf16"]
