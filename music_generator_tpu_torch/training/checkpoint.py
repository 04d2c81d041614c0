"""Best-only checkpoints (ref: train.py:23, util.py:13-23), the
counterpart of the JAX package's `training/checkpoint.py`.

One file, `<out_dir>/model.pt` (the JAX package's Orbax directory is
`model.ckpt`; the two never collide), written by `torch.save`: the
parameters as float32 CPU tensors under their keystr names (params.py, the
`.npz` layout), the optimizer state, the step and the seed.  As in the
JAX package the optimizer state and step are kept (the reference saved
weights only), and a missing or unreadable checkpoint is reported and
skipped, never fatal.  A checkpoint of the other `time_axis_kind` is
refused by name before any parameter is copied (`check_kind`)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from music_generator_tpu_torch.config import Config
from music_generator_tpu_torch.device import DeviceLike
from music_generator_tpu_torch.models.deepj import DeepJ, build_model
from music_generator_tpu_torch.params import (params_from_numpy,
                                              params_to_numpy)
from music_generator_tpu_torch.utils import param_summary


def model_path(cfg: Config) -> str:
    return os.path.join(cfg.out_dir, "model.pt")


def time_axis_kind(params) -> str:
    """The time axis's unit of keystr-named parameters: "lstm" where its
    layers hold a recurrent matrix, else "linear" (the GLRU has none)."""
    return ("lstm" if any(k.startswith(".time_axis[")
                          and k.endswith(".lstm.recurrent") for k in params)
            else "linear")


def check_kind(params, cfg: Config) -> None:
    """Raise unless the parameters' time-axis kind is the config's."""
    kind = time_axis_kind(params)
    if kind != cfg.time_axis_kind:
        raise ValueError(
            f"the checkpoint's time axis is time_axis_kind={kind!r}; this "
            f"model's is {cfg.time_axis_kind!r}")


class CheckpointStore:
    """A single-slot best-checkpoint store."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def save(self, state) -> None:
        """Write `state` (a train_step.TrainState) atomically."""
        params = {k: torch.from_numpy(v) for k, v in
                  params_to_numpy(state.model.state_dict()).items()}
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        torch.save({"params": params,
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "seed": state.seed}, tmp)
        os.replace(tmp, self.path)

    def load(self) -> dict:
        return torch.load(self.path, map_location="cpu", weights_only=True)

    def restore(self, state) -> None:
        """Load the checkpoint into `state`'s model and optimizer."""
        ckpt = self.load()
        check_kind(ckpt["params"], state.model.cfg)
        state.model.load_state_dict(params_from_numpy(
            {k: v.numpy() for k, v in ckpt["params"].items()}))
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])

    def exists(self) -> bool:
        return os.path.isfile(self.path)


def build_or_load(cfg: Config, device: DeviceLike = None, seed: int = 0,
                  allow_load: bool = True,
                  path: Optional[str] = None) -> Tuple[DeepJ, bool]:
    """A model holding the checkpoint's parameters when one can be read,
    else fresh weights from `seed` (ref: util.py:13-23, with the
    swallow-errors-and-continue semantics, logged).  Returns (model,
    loaded)."""
    model = build_model(cfg, device, seed=seed)
    print(param_summary(model.state_dict()))
    store = CheckpointStore(path or model_path(cfg))
    if not allow_load or not store.exists():
        print("Unable to load model from file.")
        return model, False
    try:
        params = store.load()["params"]
        check_kind(params, cfg)
        model.load_state_dict(params_from_numpy(
            {k: v.numpy() for k, v in params.items()}))
        print("Loaded model from file.")
        return model, True
    except Exception as e:  # parity: never fail startup on a bad checkpoint
        print(f"Unable to load model from file. ({type(e).__name__}: {e})")
        return build_model(cfg, device, seed=seed), False
