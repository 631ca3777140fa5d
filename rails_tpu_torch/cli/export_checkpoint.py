"""Export a port checkpoint as a checkpoint of the original torch implementation.

Counterpart of `rails_tpu/cli/export_checkpoint.py`:

    python -m rails_tpu_torch.cli.export_checkpoint \\
        --config ml-1m-hstu-mol --ckpt runs/<run>/ckpts/ep100 --out ref_ep100

writes a `torch.save` payload that the original repo loads with
`load_state_dict(strict=True)` (its `train.py:538-547` format, DDP `module.`
prefixes, the causal-mask buffer rebuilt): the inverse of
`cli/import_checkpoint.py`. It reads the checkpoint's weights, epoch and
batch_id and builds no model. The optimizer state is not exported: the
reference keys its moments by position, and a fine-tune there starts them
afresh. The tensors are converted on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from rails_tpu_torch.cli.train import add_config_args, config_from_args

logger = logging.getLogger("rails_tpu_torch")


def main(argv=None) -> str:
    """Export; returns the written file's path."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--ckpt", required=True, help="port checkpoint (ckpts/ep*)")
    p.add_argument("--out", required=True, help="output torch checkpoint file")
    args = p.parse_args(argv)
    cfg = config_from_args(p, args)

    import torch

    from rails_tpu_torch.compat.torch_export import export_torch_checkpoint
    from rails_tpu_torch.core.device import resolve_device

    payload = torch.load(os.path.abspath(args.ckpt), map_location=resolve_device(args.device),
                         weights_only=True)
    export_torch_checkpoint(payload["model"], cfg, args.out, epoch=int(payload["epoch"]),
                            batch_id=int(payload["batch_id"]))
    logger.info("exported %s -> %s", args.ckpt, args.out)
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
