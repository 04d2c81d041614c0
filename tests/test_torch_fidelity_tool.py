"""The port's fidelity certificate (music_generator_tpu_torch/tools/
check_fidelity.py) on the CPU, mirroring tests/test_fidelity_tool.py: the
params .npz round trip it certifies with (params.py; the JAX tool reads
the same file), the byte comparison and its event-level column, the
pre-seeded-params guard, and a whole `--device cpu` run (parent, padded
variant and CPU child process) at one seed, which must certify itself
byte for byte.  The card-against-CPU matrix runs on the card
(chip_smoke.py phase 3h)."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as small_config
from music_generator_tpu_torch.midi import midi_encode, write_midifile
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import (load_params_npz,
                                              save_params_npz)
from music_generator_tpu_torch.tools.check_fidelity import compare_dirs
from music_generator_tpu_torch.tools.check_fidelity import main as fid_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_params_npz_roundtrip_is_exact_and_jax_reads_it(tmp_path):
    cfg = small_config()
    state = build_model(cfg, "cpu", seed=3).state_dict()
    path = str(tmp_path / "params.npz")
    save_params_npz(state, path)
    restored = load_params_npz(path)
    assert set(restored) == set(state)
    for k, v in state.items():
        assert torch.equal(restored[k], v)
    # The JAX tool loads the same file leaf for leaf.
    sys.path.insert(0, REPO)
    from tools.check_fidelity import _params_from_npz as jax_from_npz
    from music_generator_tpu.config import test_config as jax_test_config
    from music_generator_tpu.models.deepj import DeepJ
    params = jax_from_npz(DeepJ(jax_test_config()), path)
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax.tree_util.keystr(p)[1:].replace("[", ".").replace("]", "")
        np.testing.assert_array_equal(np.asarray(v), state[name].numpy())


def test_compare_dirs_detects_byte_differences(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    for d in (a, b):
        (d / "same.mid").write_bytes(b"\x00\x01\x02")
    (a / "diff.mid").write_bytes(b"\x00\x01\x02\x03")
    (b / "diff.mid").write_bytes(b"\x00\x01\x02\x04")   # one byte off
    r = compare_dirs(str(a), str(b))
    assert r["files"] == 2
    assert r["mismatches"] == ["diff.mid"]
    assert not r["identical"]

    (a / "diff.mid").write_bytes(b"\x00\x01\x02\x04")
    r = compare_dirs(str(a), str(b))
    assert r["identical"] and r["mismatches"] == []
    assert r["event_identical"] and r["event_mismatches"] == []


def test_compare_dirs_event_level_column(tmp_path):
    """A volume-only byte difference is event-identical; an extra note is
    not."""
    cfg = default_config()
    roll = np.zeros((8, 128, 3), np.float32)
    roll[2:6, 60, 0] = 1.0
    roll[2:6, 60, 2] = 0.5
    roll_vol = roll.copy()
    roll_vol[2:6, 60, 2] = 0.52          # same notes, one velocity off
    roll_note = roll.copy()
    roll_note[2:6, 62, 0] = 1.0          # an extra note
    roll_note[2:6, 62, 2] = 0.5

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    for d, rx, ry in ((a, roll, roll), (b, roll_vol, roll_note)):
        write_midifile(str(d / "vol.mid"), midi_encode(rx, config=cfg))
        write_midifile(str(d / "note.mid"), midi_encode(ry, config=cfg))
    r = compare_dirs(str(a), str(b))
    assert r["mismatches"] == ["note.mid", "vol.mid"]
    assert r["event_mismatches"] == ["note.mid"]
    assert not r["identical"] and not r["event_identical"]


def test_preseeded_params_cannot_override_explicit_flags(tmp_path):
    """A stale <out>/params.npz must not win over an explicit --random-init
    or --params: both are rejected before any generation."""
    out = tmp_path / "fid"
    out.mkdir()
    (out / "params.npz").write_bytes(b"stale")
    with pytest.raises(SystemExit, match="random-init"):
        fid_main(["--out", str(out), "--random-init", "--device", "cpu"])
    with pytest.raises(SystemExit, match="params"):
        fid_main(["--out", str(out), "--params", str(tmp_path / "x.npz"),
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="not found"):
        fid_main(["--out", str(tmp_path / "fresh"), "--params",
                  str(tmp_path / "x.npz"), "--device", "cpu"])


def test_cpu_suite_certifies_itself(tmp_path):
    """--device cpu, seed 0, 2 bars (a 1-bar prime and a 1-bar
    continuation), fresh weights: the parent's files and the CPU child's
    are byte-identical, the padded variant event-identical, and the report
    is written."""
    out = tmp_path / "fid"
    report = fid_main(["--out", str(out), "--device", "cpu", "--seeds", "0",
                       "--bars", "2", "--random-init"])
    assert report["params_source"] == "random-init"
    assert report["cpu_vs_cpu"]["files"] == 5
    assert report["cpu_vs_cpu"]["identical"]
    assert report["padded_vs_cpu"]["event_identical"]
    assert json.load(open(out / "FIDELITY.json")) == report
    assert sorted(os.listdir(out / "cpu")) == [
        "genres_0_0.mid", "genres_0_1.mid", "genres_0_2.mid",
        "primed_0_0.mid", "solo_0_0.mid"]
