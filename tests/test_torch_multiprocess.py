"""The port's data parallelism (parallel/mesh.py, one process per rank)
held against the JAX package on the CPU: two ranks of
music_generator_tpu_torch/tools/mp_worker.py over gloo on 127.0.0.1 at
test_config dims.

  * Dataset.shard, shard_validity and block_epoch_permutation equal the
    JAX package's array for array;
  * a 2-rank `sharded` fit (rank r holding JAX device r's contiguous
    block, half the JAX batch a rank) against the JAX Trainer's `sharded`
    fit on a 2-device mesh, dropout 0, float32, two epochs: losses rtol
    1e-4, parameters atol 1e-4, and the two ranks' parameters bit-equal
    after every step;
  * an uneven 17-window corpus (Dataset.shard pads 9 + 8 to 9 + 9): both
    ranks run the same steps in `sharded`, `segments` and `stream` (the
    last two the same batch stream, so the same losses), `auto` picks
    `segments` past the budget, `replicated` raises, and the 2-rank
    evaluate equals the JAX evaluate over the whole corpus (it divides by
    17, not 18) within rtol 1e-5;
  * 2-rank generation (G = 3 padded to 4, a primed batch of per-stream
    triples, begin / advance) equals the port's one-process run bit for
    bit, and JAX-CPU generate's notes and .mid bytes;
  * a process group that cannot form raises, and the launcher checks.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data.dataset import Dataset as JaxDataset
from music_generator_tpu.data.dataset import (
    block_epoch_permutation as jax_block_epoch_permutation)
from music_generator_tpu.data.synth import random_batch as jax_random_batch
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.generation.sampler import (
    write_file as jax_write_file)
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.parallel.mesh import make_mesh
from music_generator_tpu.training.trainer import TrainConfig as JaxTrainConfig
from music_generator_tpu.training.trainer import Trainer as JaxTrainer
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.dataset import (Dataset,
                                                    block_epoch_permutation,
                                                    compute_genre)
from music_generator_tpu_torch.generation.sampler import (GenerationResult,
                                                          Sampler,
                                                          write_file)
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import (load_params_npz,
                                              name_to_keystr)
from music_generator_tpu_torch.parallel import mesh
from music_generator_tpu_torch.tools.mp_worker import generation_cases
from torch_mp_common import free_port, spawn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0)


def jax_params_npz(cfg, path: str, seed: int = 2):
    """JAX init_params at `cfg` saved as a keystr .npz; returns the tree."""
    params = init_params(jax.random.key(seed), cfg)
    np.savez(path, **{jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(params)[0]})
    return params


def tree_from(flat: dict, like):
    """A JAX parameter tree shaped like `like` from keystr-keyed arrays."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        jax.numpy.asarray(flat[jax.tree_util.keystr(p)]) for p, _ in paths])


def flat_params(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_params(npz, prefix: str) -> dict:
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}


# -- the sharding helpers -----------------------------------------------------

@pytest.mark.parametrize("n, count", [(17, 2), (16, 2), (5, 4), (3, 8),
                                      (1, 3), (0, 2)])
def test_shard_and_validity_equal_jax(n, count):
    arrays = [np.arange(n * k, dtype=np.float32).reshape(n, k)
              for k in (3, 2, 1, 4)]
    want_ds, got_ds = JaxDataset(*arrays), Dataset(*arrays)
    for index in range(count):
        want, got = want_ds.shard(index, count), got_ds.shard(index, count)
        assert got.shard_info == want.shard_info
        for a, b in zip((got.notes, got.targets, got.beats, got.styles),
                        (want.notes, want.targets, want.beats, want.styles)):
            np.testing.assert_array_equal(a, b)
        for q in [None] + list(range(count)):
            np.testing.assert_array_equal(got.shard_validity(q),
                                          want.shard_validity(q))


@pytest.mark.parametrize("block_len, n_blocks, per_block, seed", [
    (10, 2, 2, 0), (9, 2, 4, 1), (3, 4, 5, 2), (17, 1, 4, 3), (8, 8, 1, 4)])
def test_block_epoch_permutation_equals_jax(block_len, n_blocks, per_block,
                                            seed):
    a_rng, b_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):                   # two epochs from one rng
        got = block_epoch_permutation(block_len, n_blocks, per_block, a_rng)
        want = jax_block_epoch_permutation(block_len, n_blocks, per_block,
                                           b_rng)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        block_epoch_permutation(0, n_blocks, per_block, a_rng)


# -- training -----------------------------------------------------------------

def test_sharded_fit_tracks_jax_two_device_mesh(tmp_path):
    """20 windows, JAX batch 4 over 2 devices (blocks of 10 rows, 5 steps an
    epoch); the port's rank r holds rows [10 r, 10 r + 10) and feeds 2 a
    step.  `auto` on two ranks picks `sharded`."""
    jcfg = jax_test_config(batch_size=4, out_dir=str(tmp_path / "jax"),
                           **NO_DROPOUT)
    params = jax_params_npz(jcfg, str(tmp_path / "init.npz"))
    ranks = []
    t = threading.Thread(target=lambda: ranks.extend(spawn(
        str(tmp_path / "mp"), "fit", "--train-params", tmp_path / "init.npz",
        "--windows", 20, "--split", "contiguous", "--batch-size", 2,
        "--no-dropout", "--fit-modes", "auto", "--epochs", 2)))
    t.start()                       # the JAX fit meanwhile
    ds = JaxDataset(*jax_random_batch(jcfg, batch_size=20, seed=0))
    trainer = JaxTrainer(
        JaxDeepJ(jcfg),
        JaxTrainConfig(seed=0, checkpoint=False, tensorboard=False,
                       epoch_scan_mode="sharded"),
        mesh=make_mesh(jax.devices()[:2]))
    trainer.state = trainer.state._replace(params=params)
    want = trainer.fit(ds, epochs=2)
    assert want["epoch_scan_mode"] == "sharded"
    want_params = flat_params(trainer.state.params)

    t.join(timeout=300)
    (r0, npz0), (r1, _) = ranks
    got0, got1 = r0["fit"]["auto"], r1["fit"]["auto"]
    assert got0["epoch_scan_mode"] == "sharded"
    assert got0["steps_per_epoch"] == want["steps_per_epoch"] == [5, 5]
    assert got0["hashes"] == got1["hashes"] and len(got0["hashes"]) == 10
    assert got0["loss"] == got1["loss"]
    np.testing.assert_allclose(got0["loss"], want["loss"], rtol=1e-4)
    for k, v in port_params(npz0, "fit.auto.").items():
        np.testing.assert_allclose(v, want_params[k], rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    """One 2-rank spawn: fits over a 17-window corpus (batch 4 a rank,
    one-step segments past a budget of two batches) with evaluate, then the
    generation cases, from JAX init weights; and those weights."""
    tmp = tmp_path_factory.mktemp("uneven")
    cfg = jax_test_config(batch_size=4)
    params = jax_params_npz(cfg, str(tmp / "init.npz"))
    per_batch = sum(int(a.nbytes) // 17 for a in
                    jax_random_batch(cfg, batch_size=17, seed=0)) * 4
    ranks = spawn(str(tmp / "mp"), "fit,generate", "--params",
                  tmp / "init.npz", "--train-params", tmp / "init.npz",
                  "--windows", 17, "--split", "shard",
                  "--batch-size", 4, "--fit-modes",
                  "sharded,segments,stream,auto,replicated", "--epochs", 2,
                  "--max-bytes", 2 * per_batch, "--evaluate", "--gen",
                  "3x2s0")
    return ranks, params, str(tmp / "init.npz")


def test_uneven_corpus_keeps_ranks_in_step(uneven):
    (r0, _), (r1, _) = uneven[0]
    for mode in ("sharded", "segments", "stream", "auto"):
        a, b = r0["fit"][mode], r1["fit"][mode]
        assert a["steps_per_epoch"] == b["steps_per_epoch"] == [3, 3], mode
        assert a["loss"] == b["loss"] and np.isfinite(a["loss"]).all(), mode
        assert a["hashes"] == b["hashes"] and len(a["hashes"]) == 6, mode
    # segments (one step each) and stream take the same
    # batch stream; auto goes past the budget to segments.
    assert r0["fit"]["segments"]["loss"] == r0["fit"]["stream"]["loss"]
    assert r0["fit"]["segments"]["hashes"] == r0["fit"]["stream"]["hashes"]
    assert r0["fit"]["auto"]["epoch_scan_mode"] == "segments"
    assert r0["fit"]["auto"]["hashes"] == r0["fit"]["segments"]["hashes"]
    for r in (r0, r1):
        assert "requires a single process" in r["fit"]["replicated"]["error"]


def test_uneven_evaluate_counts_each_window_once(uneven, tmp_path):
    """The JAX evaluate of the port's trained weights over all 17 windows
    (one process, one device) is the 2-rank evaluate."""
    (r0, npz0), (r1, _) = uneven[0]
    assert r0["fit"]["sharded"]["evaluate"] == r1["fit"]["sharded"][
        "evaluate"]
    cfg = jax_test_config(batch_size=4, out_dir=str(tmp_path))
    trainer = JaxTrainer(JaxDeepJ(cfg), JaxTrainConfig(
        checkpoint=False, tensorboard=False),
        mesh=make_mesh(jax.devices()[:1]))
    trainer.state = trainer.state._replace(params=tree_from(
        port_params(npz0, "fit.sharded."), uneven[1]))
    want = trainer.evaluate(JaxDataset(*jax_random_batch(cfg, batch_size=17,
                                                         seed=0)))
    got = r0["fit"]["sharded"]["evaluate"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_two_rank_generation_is_the_one_process_bytes(uneven, tmp_path):
    (r0, npz0), (r1, npz1) = uneven[0]
    cfg = port_test_config()
    model = build_model(cfg, "cpu", state=load_params_npz(uneven[2]))
    want = generation_cases(Sampler(model), cfg, ["3x2s0"])
    assert set(port_params(npz0, "gen.")) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(npz0["gen." + k], v, err_msg=k)
        np.testing.assert_array_equal(npz1["gen." + k], v, err_msg=k)
    assert r0["gen_launches"] == r1["gen_launches"] > 0
    # ... and JAX-CPU generate on the same numpy weights: the notes (volumes
    # within float32 summation order) and the written .mid bytes.
    jcfg = jax_test_config(out_dir=str(tmp_path / "jax"))
    styles = [compute_genre(i, cfg) for i in range(3)]
    js = JaxSampler(JaxDeepJ(jcfg), uneven[1])
    jres = js.generate(styles, num_bars=2, seed=0)
    got = npz0["gen.3x2s0"]
    np.testing.assert_array_equal(got[..., :2], jres.notes[..., :2])
    np.testing.assert_allclose(got[..., 2], jres.notes[..., 2], atol=1e-5)
    mine = write_file("mp", GenerationResult(got, jres.styles),
                      cfg.replace(out_dir=str(tmp_path / "port")))
    theirs = jax_write_file("mp", jres, jcfg)
    for a, b in zip(mine, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


# -- the process group --------------------------------------------------------

def test_one_process_is_the_identity():
    assert not torch.distributed.is_initialized()
    assert (mesh.rank(), mesh.world()) == (0, 1)
    t = torch.arange(6.0).reshape(3, 2)
    mesh.all_reduce_mean_([t])
    mesh.broadcast_([t])
    assert torch.equal(mesh.all_gather_rows(t), torch.arange(6.0).reshape(
        3, 2))
    assert mesh.broadcast_bytes(b"abc", 3) == b"abc"


@pytest.mark.parametrize("env, fires", [
    ({}, False), ({"WORLD_SIZE": "1"}, False),
    ({"WORLD_SIZE": "2", "DEEPJ_DISTRIBUTED": "0"}, False)])
def test_launcher_environment(monkeypatch, env, fires):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "DEEPJ_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mesh.maybe_init_distributed("cpu") is fires


def test_launch_without_an_address_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        mesh.maybe_init_distributed("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device() == torch.device("cuda", 3)


def test_a_group_that_does_not_form_raises():
    """Rank 1 of 2 with no rank 0 anywhere: the init raises at its timeout
    (the JAX package prints and goes on alone; the port never does)."""
    code = ("import sys; from music_generator_tpu_torch.parallel import "
            "mesh\ntry:\n    mesh.init_distributed(1, 2, "
            f"'tcp://127.0.0.1:{free_port()}', device='cpu', timeout_s=1)\n"
            "except Exception as e:\n    print(type(e).__name__); "
            "sys.exit(3)\nsys.exit(0)")
    t = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert time.monotonic() - t < 100


def test_ranks_on_one_machine_build_each_kernel_once(tmp_path):
    """Two processes build the same kernel at once (as two ranks do at
    their first launch): the build lock lets one compile, and the other
    loads its library.  A stand-in nvcc counts its runs."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo run >> {tmp_path / 'runs'}\n"
                    "sleep 1\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "echo lib > \"$2\"\n")
    nvcc.chmod(0o755)
    code = ("import sys; from pathlib import Path\n"
            "from music_generator_tpu_torch.ops import _build\n"
            "_build.BUILD_DIR = Path(sys.argv[1])\n"
            "print(_build.build(['lstm2_masks'])[0].read_text())")
    env = dict(os.environ, CUDA_HOME=str(home))
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip() for o in outs] == ["lib", "lib"]
    assert (tmp_path / "runs").read_text().split() == ["run"]


TORCHRUN_SCRIPT = """
import json, os, torch
from music_generator_tpu_torch import cli
from music_generator_tpu_torch.config import test_config
torch.set_num_threads(1)
cli.default_config = test_config
hist = cli.train_main(["--device", "cpu", "--epochs", "2"])
paths = cli.generate_main(["--device", "cpu", "--bars", "1", "--out", "mp"])
cli.default_config = lambda: test_config().replace(out_dir="prof")
prof = cli.train_main(["--device", "cpu", "--epochs", "1", "--profile"])
with open(f"rank{os.environ['RANK']}.json", "w") as f:
    json.dump({"loss": hist["loss"], "mode": hist["epoch_scan_mode"],
               "steps": hist["steps_per_epoch"], "paths": paths,
               "profile_mode": prof["epoch_scan_mode"]}, f)
"""


def test_torchrun_train_and_generate(tmp_path, monkeypatch):
    """`torchrun --nproc-per-node 2` of train_main and generate_main on
    the CPU: both ranks join from the launcher's environment, train the
    same `sharded` epochs on their shards, rank 0 alone writes the
    checkpoint, the metric rows and the .mid files, and those are the
    bytes one process generates from that checkpoint; `--profile` (into
    another output directory) writes one trace a rank."""
    from music_generator_tpu_torch import cli
    from music_generator_tpu_torch.data.synth import write_synth_corpus
    cfg = port_test_config()
    write_synth_corpus(str(tmp_path), styles=[0, 1], files_per_style=1,
                       bars=4, config=cfg)
    (tmp_path / "run.py").write_text(TORCHRUN_SCRIPT)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
         "--master-port", str(free_port()), "run.py"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    r0, r1 = (json.load(open(tmp_path / f"rank{r}.json")) for r in (0, 1))
    assert r0["mode"] == r1["mode"] == "sharded"
    assert r0["loss"] == r1["loss"] and r0["steps"] == r1["steps"]
    assert len(r0["paths"]) == 3 and r1["paths"] == []
    assert "Sharding 3 generations over 2 ranks" in proc.stdout
    rows = open(tmp_path / "out" / "logs" / "metrics.jsonl").readlines()
    assert sum("epoch/epoch_loss" in r for r in rows) == 2
    assert r0["profile_mode"] == r1["profile_mode"] == "stream"
    traces = sorted(os.listdir(tmp_path / "prof" / "logs" / "profile"))
    assert [t.split(".")[1] for t in traces] == ["rank0", "rank1"], traces
    monkeypatch.setattr(cli, "default_config", lambda: cfg)
    monkeypatch.chdir(tmp_path)
    solo = cli.generate_main(["--device", "cpu", "--bars", "1", "--out",
                              "solo"])
    for a, b in zip(r0["paths"], solo):
        assert open(a, "rb").read() == open(b, "rb").read(), a
