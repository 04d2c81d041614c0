"""The weight bridge: flat `.npz` files keyed by `jax.tree_util.keystr`
paths of the JAX package's `Params` pytree <-> the port's DeepJ state dict.

A keystr path names a leaf like `.note_axis[0].lstm.kernel`; the port's
module tree mirrors the pytree, so the same leaf is the state-dict entry
`note_axis.0.lstm.kernel`, with the same shape and layout (`[259, 512]` at
flagship dims).  The committed checkpoints (artifacts/*/params.npz) are in
this layout, so they load without JAX; Orbax checkpoints cannot."""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_INDEX = re.compile(r"\[(\d+)\]")
_DOTTED_INDEX = re.compile(r"\.(\d+)(?=\.|$)")


def keystr_to_name(path: str) -> str:
    """`.time_axis[0].lstm.kernel` -> `time_axis.0.lstm.kernel`."""
    return _INDEX.sub(r".\1", path).lstrip(".")


def name_to_keystr(name: str) -> str:
    """`time_axis.0.lstm.kernel` -> `.time_axis[0].lstm.kernel`."""
    return "." + _DOTTED_INDEX.sub(r"[\1]", name)


def params_from_numpy(flat: Mapping[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
    """keystr-keyed float arrays -> a DeepJ state dict (float32 CPU
    tensors; `DeepJ.load_state_dict` checks names and shapes and copies
    them to the model's device)."""
    return {keystr_to_name(k): torch.tensor(np.asarray(v, np.float32))
            for k, v in flat.items()}


def params_to_numpy(state: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """The inverse of params_from_numpy: a state dict -> keystr-keyed
    float32 arrays, the layout `load_params_npz` reads."""
    return {name_to_keystr(k): v.detach().cpu().numpy()
            for k, v in state.items()}


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a keystr-layout `.npz` checkpoint into a state dict."""
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files})


def save_params_npz(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a state dict as a keystr-layout `.npz` (what load_params_npz
    and the JAX package's tools read)."""
    np.savez(path, **params_to_numpy(state))
