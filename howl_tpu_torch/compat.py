"""Weight bridge between the JAX package and the port, both ways.

``res8_variables_to_state_dict`` is the inverse of ``howl_tpu/compat.py``'s
``res8_torch_state_to_variables`` (the same mapping as
``howl_tpu/training/run/export_honkling.py``'s ``res8_variables_to_torch_dict``):
flax HWIO conv kernels (H = time, W = freq) become torch OIHW, flax (in, out)
dense kernels become torch (out, in), and BatchNorm ``batch_stats`` become
``running_mean`` / ``running_var``. ``res8_state_dict_to_variables`` maps a
port state dict back, as numpy in the JAX layout, so a res8 the port trained
can be compared with the JAX package and loaded by it.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def res8_variables_to_state_dict(variables) -> "OrderedDict[str, torch.Tensor]":
    """res8 variables ``{"params": ..., "batch_stats": ...}`` as numpy (or
    anything ``np.asarray`` reads) -> a state dict that
    ``Res8.load_state_dict(..., strict=True)`` accepts."""
    params = variables["params"]
    stats = variables["batch_stats"]

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    out = OrderedDict()
    for i in range(7):
        out[f"conv{i}.weight"] = t(np.asarray(params[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1))
    for i in range(1, 7):
        out[f"bn{i}.running_mean"] = t(stats[f"bn{i}"]["mean"])
        out[f"bn{i}.running_var"] = t(stats[f"bn{i}"]["var"])
        out[f"bn{i}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    out["output.weight"] = t(np.asarray(params["output"]["kernel"]).T)
    out["output.bias"] = t(params["output"]["bias"])
    return out


def res8_state_dict_to_variables(state_dict) -> dict:
    """A res8 state dict (``Res8.state_dict()``) -> variables
    ``{"params": ..., "batch_stats": ...}`` as float32 numpy in the JAX
    package's layout; the inverse of :func:`res8_variables_to_state_dict`."""

    def n(name):
        return state_dict[name].detach().to(device="cpu", dtype=torch.float32).numpy()

    params = {f"conv{i}": {"kernel": n(f"conv{i}.weight").transpose(2, 3, 1, 0)} for i in range(7)}
    params["output"] = {"kernel": n("output.weight").T, "bias": n("output.bias")}
    stats = {f"bn{i}": {"mean": n(f"bn{i}.running_mean"), "var": n(f"bn{i}.running_var")} for i in range(1, 7)}
    return {"params": params, "batch_stats": stats}
