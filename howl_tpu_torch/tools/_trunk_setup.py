"""What the live-engine tools share (counterpart of
``tools/_trunk_setup.py``): their arguments, the device rule, and one
geometry, so ``bench_streaming_trunk``, ``bench_trunk_blocked``,
``ablate_trunk_step`` and ``bench_online_dft_precision`` cannot drift onto
different configurations: res8 with 4 labels, 500 ms windows every 62.5 ms,
40 mels, 16 kHz, the bench's seeded weights (``bench.res8_numpy_variables``,
seed 0), ZMUV 0 / 1. bf16 on the card and float32 on the CPU, as the JAX
setup picks by platform.

Every tool takes ``[num_streams] [steps]`` and ``--device cuda|cpu``
(default ``cuda``: without a CUDA device it raises; ``cpu`` takes the tool's
CPU size). Times are CUDA events around whole chains of hops on the card,
the host clock on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from howl_tpu_torch.tools._study import device_parser, pick_device


class TrunkBenchSetup(NamedTuple):
    on_card: bool
    device: torch.device
    n_streams: int
    steps_arg: int
    cfg: object  # EngineConfig
    frontend: object  # FrontendConfig
    model: object
    variables: dict  # the state dict
    compute_dtype: object  # torch.bfloat16 on the card, None on the CPU
    rng: np.random.Generator


def trunk_parser(doc: str):
    """``--device`` and the positional ``num_streams`` and ``steps``."""
    p = device_parser(doc)
    p.add_argument("num_streams", type=int, nargs="?", default=None)
    p.add_argument("steps", type=int, nargs="?", default=None)
    return p


def trunk_bench_setup(device: str, num_streams, steps, default_streams_card: int, default_steps_card: int,
                      default_streams_cpu: int = 8, default_steps_cpu: int = 2) -> TrunkBenchSetup:
    """The shared res8 and engine configuration on ``device`` ("cuda" or
    "cpu"); ``num_streams`` and ``steps`` where given, else the device's
    defaults."""
    from howl_tpu_torch.bench import NUM_LABELS, res8_numpy_variables, serving_config
    from howl_tpu_torch.compat import res8_variables_to_state_dict
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    dev = pick_device(device)
    on_card = dev.type == "cuda"
    n_streams = num_streams or (default_streams_card if on_card else default_streams_cpu)
    steps = steps or (default_steps_card if on_card else default_steps_cpu)
    variables = res8_variables_to_state_dict(res8_numpy_variables(np.random.default_rng(0), NUM_LABELS))
    return TrunkBenchSetup(on_card, dev, n_streams, steps, serving_config(), FrontendConfig(n_mels=40),
                           create_model("res8", num_labels=NUM_LABELS), variables,
                           torch.bfloat16 if on_card else None, np.random.default_rng(0))


def noise(s: TrunkBenchSetup, samples: int) -> torch.Tensor:
    """(n_streams, samples) noise at 0.1, drawn on the setup's device from a
    seed that the setup's generator draws."""
    gen = torch.Generator(device=s.device).manual_seed(int(s.rng.integers(2**31)))
    return torch.randn((s.n_streams, samples), generator=gen, device=s.device) * 0.1


def engine(s: TrunkBenchSetup, kind: str, **kw):
    """One of the live engines on the setup: "online" (``OnlineEngine``),
    "incremental" (``IncrementalOnlineEngine``) or "trunk"
    (``FusedStreamingOnlineEngine``, ``hop_block`` in ``kw``)."""
    from howl_tpu_torch.inference import FusedStreamingOnlineEngine, IncrementalOnlineEngine, OnlineEngine

    cls = {"online": OnlineEngine, "incremental": IncrementalOnlineEngine, "trunk": FusedStreamingOnlineEngine}[kind]
    kw.setdefault("num_streams", s.n_streams)
    return cls(s.model, s.variables, s.cfg, s.frontend, 0.0, 1.0, compute_dtype=s.compute_dtype, device=s.device, **kw)
