"""Convert a checkpoint of the original torch implementation into the port's.

Counterpart of `rails_tpu/cli/import_checkpoint.py`:

    python -m rails_tpu_torch.cli.import_checkpoint \\
        --config ml-1m-hstu-mol --ckpt /path/to/..._ep100 --out runs/imported

writes `<out>/ckpts/ep<epoch>` (`train/checkpoint.py`), which `cli/eval.py
--ckpt` and `cli/train.py --restore-from-ckpt` restore. The reference's
AdamW moments are imported too when present, so training resumes
mid-schedule; `--skip-optimizer` gives fresh moments. A reference `.gin`
file can stand in for the registry name (`--gin-config-file`). The train
state is built on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from rails_tpu_torch.cli.train import add_config_args, config_from_args

logger = logging.getLogger("rails_tpu_torch")


def main(argv=None) -> str:
    """Import; returns the written checkpoint's path."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--ckpt", required=True, help="reference torch checkpoint")
    p.add_argument("--out", required=True, help="output run directory")
    p.add_argument("--num-items", type=int, default=None,
                   help="max item id (default: inferred from the embedding table)")
    p.add_argument("--no-strict", action="store_true",
                   help="ignore reference keys the conversion does not consume")
    p.add_argument("--skip-optimizer", action="store_true",
                   help="do not import AdamW moments even when the checkpoint has them "
                        "(training then resumes with fresh moments)")
    args = p.parse_args(argv)
    cfg = config_from_args(p, args)

    from rails_tpu_torch.compat.torch_import import (
        infer_num_items,
        fresh_model,
        import_torch_checkpoint,
        import_torch_checkpoint_full,
    )
    from rails_tpu_torch.core.device import resolve_device
    from rails_tpu_torch.train.checkpoint import save_checkpoint
    from rails_tpu_torch.train.loop import TrainState, make_optimizer

    device = resolve_device(args.device)
    strict = not args.no_strict
    if args.skip_optimizer:
        sd, epoch, batch_id = import_torch_checkpoint(args.ckpt, cfg, args.num_items, strict)
        opt_state = None
    else:
        sd, opt_state, epoch, batch_id = import_torch_checkpoint_full(
            args.ckpt, cfg, args.num_items, strict)
        if opt_state.count:
            logger.info("imported AdamW moments at step %d", opt_state.count)
    model = fresh_model(cfg, infer_num_items(sd, cfg, args.num_items), device)
    model.load_state_dict(sd, strict=True)
    optimizer = make_optimizer(cfg, model)
    if opt_state is not None:
        for ours, theirs in ((optimizer.state.mu, opt_state.mu),
                             (optimizer.state.nu, opt_state.nu)):
            for name, t in ours.items():
                t.copy_(theirs[name])
        optimizer.state.count = opt_state.count
    state = TrainState(model, optimizer, optimizer.state.count)
    ckpt_dir = os.path.join(args.out, "ckpts")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = save_checkpoint(ckpt_dir, state, epoch=epoch, batch_id=batch_id,
                           config_json=cfg.to_json(),
                           debug_str=f"imported from {os.path.abspath(args.ckpt)}")
    logger.info("imported %s (epoch %d) -> %s", args.ckpt, epoch, path)
    print(path)
    return path


if __name__ == "__main__":
    main()
