"""Export a trained model's weights as honkling (browser JS) JSON
(counterpart of ``howl_tpu/training/run/export_honkling.py``; ref:
training/run/export_honkling.py:9-36).

    python -m howl_tpu_torch.training.run.export_honkling -i WS/model-best.pt -o weights.js --name RES8

The input is a port checkpoint: a ``model.pt`` / ``model-best.pt`` state
dict, or a workspace directory (its ``model-best.pt``). Honkling expects
torch tensor layouts under the reference's names. The state dict goes
through ``compat.state_dict_to_variables`` into the JAX package's variables,
and from there the dump is the JAX tool's: conv kernels (H, W, I, O) ->
(O, I, H, W), dense kernels (in, out) -> (out, in), BatchNorm batch_stats ->
running_mean / running_var, plus the scale entries honkling's RES8 loader
expects. So the file is byte for byte the JAX tool's for the same weights,
and the names come from one table. A pure format conversion on the host.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from howl_tpu_torch.compat import state_dict_to_variables
from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger


def res8_variables_to_torch_dict(variables: dict) -> dict:
    """Map res8 variables onto the reference res8 state_dict names (ref
    howl/model/cnn.py:113-125: conv0..conv6, bn1..bn6, output)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = {}
    for i in range(7):
        kernel = np.asarray(params[f"conv{i}"]["kernel"])  # (H, W, I, O)
        out[f"conv{i}.weight"] = kernel.transpose(3, 2, 0, 1).tolist()
    for i in range(1, 7):
        bn = stats.get(f"bn{i}", {})
        out[f"bn{i}.running_mean"] = np.asarray(bn["mean"]).tolist()
        out[f"bn{i}.running_var"] = np.asarray(bn["var"]).tolist()
        out[f"bn{i}.num_batches_tracked"] = 0
    out["output.weight"] = np.asarray(params["output"]["kernel"]).T.tolist()
    out["output.bias"] = np.asarray(params["output"]["bias"]).tolist()
    return out


def _flatten(tree, path=()):
    """(path, leaf) pairs of a nested dict in ``jax.tree_util``'s order:
    keys sorted at every level."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (key,))
    else:
        yield path, tree


def generic_variables_to_dict(variables: dict) -> dict:
    """Any variables pytree as dotted names in torch layouts."""
    out = {}
    for collection, tree in variables.items():
        for path, leaf in _flatten(tree):
            name = ".".join(str(k) for k in path)
            arr = np.asarray(leaf)
            if name.endswith("kernel") and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif name.endswith("kernel") and arr.ndim == 2:
                arr = arr.T
            prefix = "" if collection == "params" else f"{collection}."
            out[prefix + name] = arr.tolist()
    return out


def honkling_dict(model: str, name: str, state_dict) -> dict:
    """The JSON object written for ``state_dict`` of model ``model``."""
    variables = state_dict_to_variables(model, state_dict)
    if model == "res8":
        json_dict = res8_variables_to_torch_dict(variables)
        if name == "RES8":
            # honkling's RES8 loader expects these scale entries (ref :24-27)
            for key in ("scale1.scale", "scale3.scale", "scale5.scale"):
                json_dict[key] = np.ones(45).tolist()
        return json_dict
    return generic_variables_to_dict(variables)


def load_checkpoint(path) -> dict:
    """A port state dict from a checkpoint file or a workspace directory
    (its ``model-best.pt``), on the CPU."""
    path = Path(path)
    if path.is_dir():
        path = path / "model-best.pt"
    return torch.load(path, map_location="cpu", weights_only=True)


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--input-file", "-i", type=str, required=True, help="model .pt checkpoint or a workspace directory"),
        opt("--output-file", "-o", type=str, required=True),
        opt("--name", type=str, required=True, help="honkling model name (e.g. RES8)"),
        opt("--model", type=str, default="res8"),
        opt("--num-labels", type=int, default=4, help="the JAX tool's flag; the checkpoint holds its label count"),
    )
    args = apb.parser.parse_args(args)
    json_dict = honkling_dict(args.model, args.name, load_checkpoint(args.input_file))
    with Path(args.output_file).open("w") as f:
        f.write(f"weights['{args.name}'] = ")
        json.dump(json_dict, f)
    Logger.info(f"wrote {len(json_dict)} tensors to {args.output_file}")


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
