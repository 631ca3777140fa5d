"""Training CLI.

Counterpart of `rails_tpu/cli/train.py`: a named experiment config (or a
reference `.gin` file) with dotted `--set` overrides, trained by
`train/driver.py:run_training` on the card unless `--device cpu`.

Usage:
  python -m rails_tpu_torch.cli.train --config ml-20m-hstu-mol \\
      [--set train.local_batch_size=64] [--workdir runs] \\
      [--restore-from-ckpt runs/<run>/ckpts/ep3] [--num-epochs N]
Data-parallel over N cards of one host (one process a card):
  torchrun --nproc-per-node N -m rails_tpu_torch.cli.train --config ... --distributed
or every process given the group: `--coordinator host:port --num-processes N
--process-id I`.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import logging
import sys

import torch

from rails_tpu_torch.core.config import (
    ExperimentConfig,
    get_experiment_config,
    list_experiment_configs,
)


def apply_override(cfg: ExperimentConfig, dotted: str, raw_value: str) -> ExperimentConfig:
    """Apply `section.field=value`, the value parsed as a Python literal.

    `true`/`false` in any case parse as booleans (the string "false" is
    truthy); a value that is no literal stays a string."""
    low = raw_value.strip().lower()
    if low in ("true", "false"):
        value = low == "true"
    else:
        try:
            value = ast.literal_eval(raw_value)
        except (ValueError, SyntaxError):
            value = raw_value

    def rec(obj, path):
        if len(path) == 1:
            return dataclasses.replace(obj, **{path[0]: value})
        return dataclasses.replace(obj, **{path[0]: rec(getattr(obj, path[0]), path[1:])})

    return rec(cfg, dotted.split("."))


def add_config_args(p: argparse.ArgumentParser) -> None:
    """The arguments that pick a config, shared by the train, eval and sweep
    CLIs."""
    p.add_argument("--config", default=None,
                   help=f"experiment name, one of {list_experiment_configs()}")
    p.add_argument("--gin-config-file", default=None,
                   help="a reference .gin config file to import instead of --config "
                        "(rails_tpu_torch/compat/gin_import.py)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. train.learning_rate=3e-4")
    p.add_argument("--data-root", default=".")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card); cpu runs the kernels' "
                        "plain versions")


def config_from_args(p: argparse.ArgumentParser, args: argparse.Namespace) -> ExperimentConfig:
    """The config that `--config` xor `--gin-config-file` names, with the
    `--set` overrides applied."""
    if (args.config is None) == (args.gin_config_file is None):
        p.error("exactly one of --config / --gin-config-file is required")
    if args.gin_config_file is not None:
        from rails_tpu_torch.compat.gin_import import experiment_config_from_gin

        result = experiment_config_from_gin(args.gin_config_file)
        for line in result.ignored:
            logging.info("gin import: ignored binding %s", line)
        cfg = result.config
    else:
        cfg = get_experiment_config(args.config)
    for ov in args.set:
        key, _, val = ov.partition("=")
        cfg = apply_override(cfg, key, val)
    return cfg


def parse_config(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--workdir", default="runs")
    p.add_argument("--restore-from-ckpt", default=None)
    p.add_argument("--num-epochs", type=int, default=None)
    # Several processes, one a card (the reference's 2-process DDP,
    # `train.py:589-603`): --distributed alone takes torchrun's environment;
    # elsewhere give the coordinator, the count and this process's index.
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator", default=None,
                   help="process 0's address host:port (or a torch.distributed init method)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    args.cfg = config_from_args(p, args)
    return args


def main(argv=None):
    """Train; returns the driver's `TrainResult`."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    args = parse_config(argv)
    from rails_tpu_torch.core import distributed

    joined = False
    if args.distributed or args.coordinator or (args.num_processes or 0) > 1:
        joined = not torch.distributed.is_initialized()
        distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes, process_id=args.process_id,
                               device=args.device)
        logging.getLogger("rails_tpu_torch").info(
            "process %d/%d on %s", distributed.process_index(), distributed.process_count(),
            distributed.device())
    from rails_tpu_torch.train.driver import run_training

    try:
        result = run_training(args.cfg, data_root=args.data_root, workdir=args.workdir,
                              restore_from=args.restore_from_ckpt, num_epochs=args.num_epochs,
                              device=args.device)
    finally:
        if joined:
            distributed.shutdown()
    logging.getLogger("rails_tpu_torch").info("final metrics: %s", result.final_metrics)
    return result


if __name__ == "__main__":
    main()
