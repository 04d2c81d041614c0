"""Import and export reference (Keras 2 HDF5) weights: the counterpart of
the JAX package's `training/keras_import.py`, on the port's own HDF5
reader and writer (`utils/hdf5.py`; no h5py).

The reference trains with Keras and checkpoints weights only, to
`out/model.h5` (ref: train.py:23).  `load_keras_weights` maps such a file
onto the port's DeepJ state dict (params.py names, `time_axis.0.lstm.kernel`
...); `save_keras_weights` writes a file the reference's positional
`model.load_weights` (ref: util.py:19) accepts.

The layout, and what a naive importer gets wrong (the JAX module's
docstring has the derivation):

1. Groups are named after the `TimeDistributed` wrapper
   (`time_distributed_4`), not the inner layer; the weight names inside
   carry the inner layer (`lstm_1/kernel:0`), the wrapper only
   (`time_distributed_4/kernel:0`) or both.  Groups are classified by the
   weight names inside them and by weight shapes, never by group name.
2. `Model.layers` is depth-sorted: `style` first, the style-projection
   denses before the LSTMs of their block, the heads last
   (`REFERENCE_LAYER_TABLE`, which tests pin to the JAX package's table and
   its graph derivation).  The loader assigns the four unnamed denses and
   four LSTMs by expected kernel shape first, falls back to file order when
   a config's dims collide, and checks every kernel shape against the
   config, so a misassignment fails loudly.

Keras's LSTM gate order is i, f, c, o, the port's too, and kernels are
stored [in, 4H] / recurrent [H, 4H], so weights drop in untransposed.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from music_generator_tpu_torch.config import Config
from music_generator_tpu_torch.models.deepj import feature_dim
from music_generator_tpu_torch.params import name_to_keystr
from music_generator_tpu_torch.training.checkpoint import time_axis_kind
from music_generator_tpu_torch.utils import hdf5

# The reference training model's Model.layers in Keras depth order (the
# JAX package's table): (group name, kind), kind None for weightless layers.
REFERENCE_LAYER_TABLE = (
    ("input_1", None), ("input_3", None),
    ("dropout_1", None), ("style", "style"),
    ("time_distributed_1", "conv"), ("input_2", None), ("dense_1", "dense"),
    ("activation_1", None), ("dropout_2", None), ("time_distributed_3", None),
    ("lambda_1", None), ("lambda_2", None), ("lambda_3", None),
    ("dropout_4", None), ("time_distributed_2", None), ("activation_2", None),
    ("concatenate_1", None), ("dropout_5", None), ("dense_2", "dense"),
    ("permute_1", None), ("permute_2", None), ("time_distributed_5", None),
    ("add_1", None), ("activation_3", None),
    ("time_distributed_4", "lstm"), ("dropout_7", None),
    ("dropout_6", None), ("permute_3", None),
    ("add_2", None), ("input_4", None),
    ("time_distributed_6", "lstm"), ("dropout_3", None), ("dense_3", "dense"),
    ("dropout_8", None), ("lambda_4", None), ("time_distributed_7", None),
    ("permute_4", None), ("reshape_1", None), ("activation_4", None),
    ("concatenate_2", None), ("dropout_9", None), ("dense_4", "dense"),
    ("add_3", None), ("time_distributed_9", None),
    ("time_distributed_8", "lstm"), ("activation_5", None),
    ("dropout_10", None), ("dropout_11", None),
    ("add_4", None),
    ("time_distributed_10", "lstm"),
    ("dropout_12", None),
    ("note_dense", "note_dense"), ("volume_dense", "volume_dense"),
    ("concatenate_3", None),
)

# Each weighted group: (inner layer name, the state-dict prefix it holds).
_GROUP_LEAVES = {
    "style": ("style", "style_embed"),
    "time_distributed_1": ("conv1d_1", "conv"),
    "dense_1": ("dense_1", "time_axis.0.style_proj"),
    "dense_2": ("dense_2", "time_axis.1.style_proj"),
    "time_distributed_4": ("lstm_1", "time_axis.0.lstm"),
    "time_distributed_6": ("lstm_2", "time_axis.1.lstm"),
    "dense_3": ("dense_3", "note_axis.0.style_proj"),
    "dense_4": ("dense_4", "note_axis.1.style_proj"),
    "time_distributed_8": ("lstm_3", "note_axis.0.lstm"),
    "time_distributed_10": ("lstm_4", "note_axis.1.lstm"),
    "note_dense": ("note_dense", "note_dense"),
    "volume_dense": ("volume_dense", "volume_dense"),
}
# Keras part names -> the port's leaf names, in Keras's weight order.
_PARTS = {"dense": (("kernel", "kernel"), ("bias", "bias")),
          "lstm": (("kernel", "kernel"), ("recurrent_kernel", "recurrent"),
                   ("bias", "bias"))}


def _decode(names) -> List[str]:
    return [n.decode() if isinstance(n, bytes) else str(n)
            for n in np.atleast_1d(names)]


def save_keras_weights(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a DeepJ state dict as a reference-layout Keras 2 weights file
    (the inverse of load_keras_weights): every layer of
    REFERENCE_LAYER_TABLE a group, weightless ones with an empty
    `weight_names`, and the root attributes `layer_names`, `backend` and
    `keras_version`.  A linear time axis (no recurrent matrix) has no
    Keras layout and is refused."""
    if time_axis_kind([name_to_keystr(n) for n in state]) != "lstm":
        raise ValueError("the state's time axis is time_axis_kind='linear',"
                         " which has no Keras mapping")
    with hdf5.Writer(path) as f:
        for group_name, kind in REFERENCE_LAYER_TABLE:
            g = f.create_group(group_name)
            if kind is None:
                g.attrs["weight_names"] = np.array([], dtype="S1")
                continue
            inner, prefix = _GROUP_LEAVES[group_name]
            parts = _PARTS["lstm" if kind == "lstm" else "dense"]
            names = [f"{inner}/{keras}:0" for keras, _ in parts]
            g.attrs["weight_names"] = np.array([n.encode() for n in names])
            for n, (_, leaf) in zip(names, parts):
                g.create_dataset(n, data=state[f"{prefix}.{leaf}"].detach()
                                 .cpu().numpy().astype(np.float32))
        f.attrs["layer_names"] = np.array(
            [name.encode() for name, _ in REFERENCE_LAYER_TABLE])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.1.6"


_LSTM_PART = {"kernel": 0, "recurrent_kernel": 1, "bias": 2}


def _classify(group_name: str, weight_names: Sequence[str],
              arrays: Sequence[np.ndarray]) -> Optional[str]:
    """Classify a weighted group by the weight names inside it, falling
    back to weight shapes for Keras variants whose variables are scoped
    under the wrapper name only.  Returns one of
    'style' | 'note_dense' | 'volume_dense' | 'conv' | 'lstm' | 'dense'
    or None when unrecognizable."""
    tokens = set()
    for wn in weight_names:
        for comp in wn.split("/"):
            tokens.add(comp.split(":")[0])
    tokens.add(group_name)

    for named in ("note_dense", "volume_dense", "style"):
        if named in tokens:
            return named
    stripped = {re.sub(r"_\d+$", "", t) for t in tokens}
    if "conv1d" in stripped:
        return "conv"
    if "lstm" in stripped:
        return "lstm"
    if "dense" in stripped:
        return "dense"

    # Shape sniffing (wrapper-scoped names carry no inner-layer token).
    if len(arrays) == 3 and arrays[0].ndim == 2 and arrays[1].ndim == 2 \
            and arrays[2].ndim == 1 \
            and arrays[0].shape[1] == arrays[1].shape[1] \
            and arrays[1].shape[1] == 4 * arrays[1].shape[0]:
        return "lstm"
    if len(arrays) == 2 and arrays[0].ndim == 3 and arrays[1].ndim == 1:
        return "conv"
    if len(arrays) == 2 and arrays[0].ndim == 2 and arrays[1].ndim == 1:
        return "dense"
    return None


def _order_parts(weight_names: Sequence[str], arrays: Sequence[np.ndarray],
                 part_index) -> List[np.ndarray]:
    """Order a group's arrays as [kernel, (recurrent_kernel,) bias] using
    weight-name basenames when they are recognizable, else keep file order
    (Keras saves layer.weights order, which already matches)."""
    roles = []
    for wn in weight_names:
        base = wn.split("/")[-1].split(":")[0]
        roles.append(part_index.get(base))
    if sorted(r for r in roles if r is not None) == list(range(len(arrays))):
        out: List[np.ndarray] = [None] * len(arrays)  # type: ignore
        for role, a in zip(roles, arrays):
            out[role] = a
        return out
    return list(arrays)


def _shared_identity(weight_names: Sequence[str]) -> Optional[str]:
    """Inner-layer identity token ('lstm_3', 'dense_2', ...) used to dedupe
    groups that carry the same shared layer twice (the reference shares the
    note-axis Dense/LSTM layers between its training and generation graphs,
    ref: model.py:92-93,110,119)."""
    for wn in weight_names:
        for comp in wn.split("/"):
            comp = comp.split(":")[0]
            if re.fullmatch(r"(lstm|dense|conv1d)_\d+", comp):
                return comp
    return None


def load_keras_weights(path: str, cfg: Config) -> Dict[str, torch.Tensor]:
    """Read a reference `model.h5` (Keras 2 weights-only HDF5) into a DeepJ
    state dict (float32 CPU tensors under params.py's names).

    Accepts the genuine Keras layout (wrapper groups with inner-layer
    weight names), the wrapper-scoped variant (classified by shape), the
    JAX package's pre-r3 bare-layer layout, and `save_model` files
    (everything under 'model_weights').  Raises ValueError when the file's
    layer inventory does not match the DeepJ architecture for `cfg`, and
    for `time_axis_kind="linear"`: Keras 2 files hold LSTM time axes, and
    the linear kind has no Keras mapping (nor has the JAX importer)."""
    if cfg.time_axis_kind != "lstm":
        raise ValueError(
            f"Keras 2 weights hold an LSTM time axis; time_axis_kind="
            f"{cfg.time_axis_kind!r} has no Keras mapping")
    with hdf5.File(path) as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = _decode(root.attrs["layer_names"])

        convs, denses, lstms = [], [], []
        named = {}
        seen_shared = set()
        for name in layer_names:
            group = root[name]
            weight_names = _decode(group.attrs["weight_names"])
            if not len(weight_names):
                continue                      # Input/Dropout/Lambda layers
            arrays = [np.asarray(group[n]) for n in weight_names]
            ident = _shared_identity(weight_names)
            if ident is not None:
                if ident in seen_shared:
                    continue                  # shared layer saved twice
                seen_shared.add(ident)
            kind = _classify(name, weight_names, arrays)
            if kind in ("style", "note_dense", "volume_dense"):
                parts = _order_parts(
                    weight_names, arrays, {"kernel": 0, "bias": 1})
                if kind in named:
                    # A named layer under two groups: identical content
                    # dedupes, conflicting content is refused.
                    if all(np.array_equal(a, b)
                           for a, b in zip(named[kind], parts)):
                        continue
                    raise ValueError(
                        f"duplicate '{kind}' groups with different weights")
                named[kind] = parts
            elif kind == "conv":
                convs.append(_order_parts(
                    weight_names, arrays, {"kernel": 0, "bias": 1}))
            elif kind == "lstm":
                lstms.append(_order_parts(weight_names, arrays, _LSTM_PART))
            elif kind == "dense":
                denses.append(_order_parts(
                    weight_names, arrays, {"kernel": 0, "bias": 1}))
            # else: unrecognizable group — fall through to the count check

    missing = {"style", "note_dense", "volume_dense"} - set(named)
    if missing or len(convs) != 1 or len(denses) != 4 or len(lstms) != 4:
        raise ValueError(
            f"not a DeepJ Keras checkpoint: missing={sorted(missing)}, "
            f"conv1d={len(convs)}, dense={len(denses)}, "
            f"lstm={len(lstms)} (want 1/4/4)")

    state: Dict[str, torch.Tensor] = {}

    def put(prefix: str, leaves: Sequence[str], arrays) -> None:
        for leaf, a in zip(leaves, arrays):
            state[f"{prefix}.{leaf}"] = torch.from_numpy(
                np.asarray(a, np.float32).copy())

    def dense(w, in_dim, out_dim, what, prefix) -> None:
        if w[0].shape != (in_dim, out_dim):
            raise ValueError(f"{what}: kernel {w[0].shape} != "
                             f"{(in_dim, out_dim)} for this config")
        put(prefix, ("kernel", "bias"), w)

    def lstm(w, in_dim, units, what, prefix) -> None:
        if w[0].shape != (in_dim, 4 * units):
            raise ValueError(f"{what}: kernel {w[0].shape} != "
                             f"{(in_dim, 4 * units)} for this config")
        put(prefix, ("kernel", "recurrent", "bias"), w)

    time_in = [feature_dim(cfg), cfg.time_axis_units]
    note_in = [cfg.time_axis_units + cfg.note_units, cfg.note_axis_units]

    # Keras depth order puts the unnamed groups in module order: denses =
    # time 0, time 1, note 0, note 1; the same for the LSTMs.  At DeepJ
    # dims every slot has a distinct kernel shape, so assign by expected
    # shape first and keep file order only when shapes collide (checked
    # loudly below).
    def assign(pool, expected_shapes):
        if sorted(map(tuple, expected_shapes)) != sorted(
                set(map(tuple, expected_shapes))):
            return list(pool)            # colliding dims: keep order
        out, rest = [], list(pool)
        for shape in expected_shapes:
            i = next((i for i, w in enumerate(rest)
                      if w[0].shape == shape), None)
            if i is None:
                return list(pool)        # unmatched: keep order
            out.append(rest.pop(i))
        return out

    denses = assign(denses, [(cfg.style_units, time_in[0]),
                             (cfg.style_units, time_in[1]),
                             (cfg.style_units, note_in[0]),
                             (cfg.style_units, note_in[1])])
    lstms = assign(lstms, [(time_in[0], 4 * cfg.time_axis_units),
                           (time_in[1], 4 * cfg.time_axis_units),
                           (note_in[0], 4 * cfg.note_axis_units),
                           (note_in[1], 4 * cfg.note_axis_units)])

    dense(named["style"], cfg.num_styles, cfg.style_units, "style",
          "style_embed")
    conv_k, conv_b = convs[0]
    conv_shape = (2 * cfg.octave, cfg.note_units, cfg.octave_units)
    if conv_k.shape != conv_shape:
        raise ValueError(f"conv1d kernel {conv_k.shape} != {conv_shape}")
    put("conv", ("kernel", "bias"), (conv_k, conv_b))
    for axis, ins, units, off in (("time", time_in, cfg.time_axis_units, 0),
                                  ("note", note_in, cfg.note_axis_units, 2)):
        for l in range(2):
            prefix = f"{axis}_axis.{l}"
            dense(denses[off + l], cfg.style_units, ins[l],
                  f"{axis} style_proj[{l}]", f"{prefix}.style_proj")
            lstm(lstms[off + l], ins[l], units, f"{axis} lstm[{l}]",
                 f"{prefix}.lstm")
    dense(named["note_dense"], cfg.note_axis_units, 2, "note_dense",
          "note_dense")
    dense(named["volume_dense"], cfg.note_axis_units, 1, "volume_dense",
          "volume_dense")
    return state
