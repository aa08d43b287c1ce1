"""Import a trained reference (castorini/howl) workspace as a port workspace
(counterpart of ``howl_tpu/training/run/import_workspace.py``).

Reads ``model{-best}.pt.bin``, ``zmuv.pt.bin`` and ``settings.json`` and
writes ``model{-best}.pt``, ``zmuv.json``, ``settings.json`` and
``cmd-args.json``, which ``howl_tpu_torch.hub.load_workspace_engine`` serves
(``howl_tpu_torch/compat.py`` has the families it reads). A pure format
conversion: nothing runs on a card.

    python -m howl_tpu_torch.training.run.import_workspace -i /path/to/howl-models/howl/hey-fire-fox -o ws/hey-ff
"""

from __future__ import annotations

import sys

from howl_tpu_torch.utils.args_utils import ArgumentParserBuilder, opt
from howl_tpu_torch.utils.logger import Logger


def run(args=None):
    apb = ArgumentParserBuilder()
    apb.add_options(
        opt("--input-workspace", "-i", type=str, required=True,
            help="reference workspace dir (model-best.pt.bin, zmuv.pt.bin, settings.json)"),
        opt("--output-workspace", "-o", type=str, required=True),
        opt("--model", type=str, default=None,
            help="architecture name; defaults to the source cmd-args.json 'model' entry"),
    )
    args = apb.parser.parse_args(args)

    from howl_tpu_torch.compat import import_reference_workspace

    workspace = import_reference_workspace(args.input_workspace, args.output_workspace, args.model)
    Logger.info(f"imported reference workspace into {workspace.path}")
    Logger.info("serve it with howl_tpu_torch.hub.load_workspace_engine or howl_tpu_torch.client.HowlClient")
    return workspace


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
