"""Checkpoint save and restore with `torch.save` / `torch.load`.

Counterpart of `rails_tpu/train/checkpoint.py`, in its layout:
`<ckpt_dir>/ep{N}` (the payload), `ep{N}.meta.json` (epoch, batch_id,
debug_str) and `<ckpt_dir>/config.json`. The payload holds plain tensors,
ints and dicts only, so it loads with `torch.load(weights_only=True)`:

- "model": the model's state dict;
- "opt_state": the optimizer's `FusedAdamWState` (count, mu, nu by
  parameter name);
- "step", "epoch", "batch_id";
- "generator": the state of the `torch.Generator` the train step draws
  from. JAX's step folds one fixed key with `state.step`
  (`rails_tpu/train/loop.py:174`), so a resumed run draws what an
  uninterrupted one would; the port's step advances one generator, so its
  state travels with the checkpoint and a resume continues the same
  stream.

JAX falls back to fresh optimizer moments when a checkpoint was written
under the other `train.fused_optimizer` setting, because optax's chain
state and its `FusedAdamWState` differ in layout (:76-106). The port has one
layout under both settings (`FusedAdamW` keeps mu and nu for every
parameter; the flag only routes large leaves through K7), so a checkpoint
restores whole across the flag, and any mismatch of the model or the
moments raises. Under `torch.distributed` the primary process writes and
every process waits at a barrier.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from rails_tpu_torch.core import distributed
from rails_tpu_torch.train.loop import TrainState


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def save_checkpoint(
    ckpt_dir: str,
    state: TrainState,
    epoch: int,
    batch_id: int,
    generator: Optional[torch.Generator] = None,
    config_json: Optional[str] = None,
    debug_str: Optional[str] = None,
) -> str:
    """Write `<ckpt_dir>/ep{epoch}` and its metadata; returns the path. Every
    process calls it; the primary writes."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"ep{epoch}"))
    if distributed.is_primary():
        opt = state.optimizer.state
        payload = {
            "model": _host(state.model.state_dict()),
            "opt_state": {"count": int(opt.count), "mu": _host(opt.mu), "nu": _host(opt.nu)},
            "step": int(state.step),
            "epoch": int(epoch),
            "batch_id": int(batch_id),
            "generator": None if generator is None else generator.get_state(),
        }
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(path + ".meta.json", "w") as f:
            json.dump({"epoch": epoch, "batch_id": batch_id, "debug_str": debug_str}, f,
                      indent=2)
        if config_json is not None:
            with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
                f.write(config_json)
    _barrier()
    return path


def _copy_moments(name: str, dst: dict, src: dict, path: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"checkpoint {path}: optimizer {name} has parameters "
                         f"{sorted(set(src) ^ set(dst))} that the model does not match")
    for k, t in dst.items():
        if t.shape != src[k].shape:
            raise ValueError(f"checkpoint {path}: optimizer {name}[{k}] is "
                             f"{tuple(src[k].shape)}, the model's {tuple(t.shape)}")
        t.copy_(src[k])


@torch.no_grad()
def restore_checkpoint(
    path: str, state: TrainState, generator: Optional[torch.Generator] = None,
) -> Tuple[TrainState, int, int]:
    """Load a checkpoint into a freshly made state, in place: the model's
    weights (strictly: a checkpoint of another config raises), the optimizer
    moments and count, and with `generator` its saved stream. Returns
    (state, epoch, batch_id); training resumes at epoch + 1."""
    payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    opt, saved = state.optimizer.state, payload["opt_state"]
    _copy_moments("mu", opt.mu, saved["mu"], path)
    _copy_moments("nu", opt.nu, saved["nu"], path)
    opt.count = int(saved["count"])
    if generator is not None and payload["generator"] is not None:
        generator.set_state(payload["generator"])
    return (TrainState(state.model, state.optimizer, int(payload["step"])),
            int(payload["epoch"]), int(payload["batch_id"]))
