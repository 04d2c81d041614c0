"""One rank of a data-parallel run of the port (the counterpart of the JAX
package's `tools/mp_worker.py`): it joins a process group on 127.0.0.1 and
drives the port's data-parallel paths, so that a test or `chip_smoke.py`
can start WORLD of them and compare what they wrote with a one-process
run.

    python -m music_generator_tpu_torch.tools.mp_worker RANK WORLD PORT OUT
        MODES [--device D] [--backend gloo|nccl] [--config test|default]
        [options]

The device defaults to the card: cuda:RANK under nccl (one rank per card),
cuda:0 under gloo (ranks sharing one card); `--device cpu` runs on the
CPU over gloo.

MODES is a comma-separated list, run in order:
  step      one training step on this rank's rows of a seeded global batch
            (`--windows` rows of random_batch(seed=0), rank r the
            contiguous block r); then `--time-steps` more steps and as
            many all-reduces of a bucket the size of the gradients, timed;
  fit       Trainer.fit (`--epochs`) from the same weights in each of
            `--fit-modes` over the rank's rows of the corpus of
            `--windows` rows (seed 0) (`--split shard`: Dataset.shard; `contiguous`:
            block r), with a hash of the parameters after every step, and
            with `--evaluate` Trainer.evaluate after the first fit;
  generate  Sampler.generate at `--gen` cases (GxBARSsSEED, e.g. 3x8s0),
            plus a primed batch of per-stream triples and an incremental
            begin / advance run (`generation_cases`);
  serve     every rank builds the same GenerationService; rank 0 leads the
            replay channel on 127.0.0.1:`--serve-port` and makes the
            requests of `serving_requests`, the others follow.
Training starts from `--train-params` (a keystr .npz) or fresh weights
from seed 0, generation and serving from `--params` or the same fresh
weights.  Each mode records the launches of the kernels on its path
(training: the four biaxial kernels and the plain stacks' calls; the
pitch loop: launches on the card, plain calls on the CPU).  Every rank
writes OUT.RANK.json and OUT.RANK.npz (parameters, notes) and leaves the
process group.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from music_generator_tpu_torch.config import Config, default_config
from music_generator_tpu_torch.config import test_config
from music_generator_tpu_torch.data.dataset import Dataset, compute_genre
from music_generator_tpu_torch.data.synth import random_batch
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.parallel import mesh
from music_generator_tpu_torch.params import (load_params_npz,
                                              params_to_numpy)


def param_hash(model) -> str:
    """sha256 of every parameter's bytes, in state-dict order."""
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def params_copy(model, prefix: str) -> Dict[str, np.ndarray]:
    """The model's parameters as keystr-keyed numpy copies (a CPU
    tensor's numpy view would follow later steps)."""
    return {prefix + k: np.array(v) for k, v in
            params_to_numpy(model.state_dict()).items()}


def rank_rows(ds: Dataset, split: str) -> Dataset:
    """This rank's rows: Dataset.shard, or the contiguous block r (the
    rows a JAX mesh's device r holds)."""
    if split == "shard":
        return ds.shard(mesh.rank(), mesh.world())
    n = len(ds) // mesh.world()
    lo = mesh.rank() * n
    return Dataset(*(a[lo:lo + n] for a in (ds.notes, ds.targets, ds.beats,
                                              ds.styles)))


def _prime_roll(cfg: Config) -> np.ndarray:
    """A fixed two-bar prime (the JAX worker's)."""
    prime = np.zeros((2 * cfg.notes_per_bar, cfg.num_notes, 3), np.float32)
    prime[1, 5, 0] = prime[1, 5, 2] = 1.0
    last = 2 * cfg.notes_per_bar - 1
    prime[last, min(20, cfg.num_notes - 1), 0] = 1.0
    prime[last, min(20, cfg.num_notes - 1), 2] = 0.5
    return prime


def generation_cases(sampler, cfg: Config, cases: Sequence[str]
                     ) -> Dict[str, np.ndarray]:
    """The generations the worker compares with a one-process run: each
    case "GxBARSsSEED" (the genre mixtures cycled over G streams), a primed
    1-bar G = 3 batch of per-stream (seed, index, temperature) triples run
    as a full 2-bar chunk, and a G = 3 `begin` with two `advance` calls."""
    out = {}
    for case in cases:
        g, rest = case.split("x")
        bars, seed = rest.split("s")
        styles = [compute_genre(i % 3, cfg) for i in range(int(g))]
        out[case] = sampler.generate(styles, num_bars=int(bars),
                                     seed=int(seed)).notes
    styles = [compute_genre(i, cfg) for i in range(3)]
    out["primed"] = sampler.generate(
        styles, num_bars=1, seeds=[5, 6, 7], stream_indices=[0, 4, 9],
        temperature=[1.0, 0.9, 1.1], prime=_prime_roll(cfg), chunk_bars=2,
        pad_partial_chunk=True).notes
    gen = sampler.begin(styles, chunk_bars=1, seed=3)
    out["begin"] = np.concatenate([gen.advance(1), gen.advance(1)], axis=1)
    gen.close()
    return out


def serving_requests(service, cfg: Config, batch_sizes: Sequence[int]
                     ) -> Dict[str, bytes]:
    """The requests the worker's leader makes, in this order: a 2-bar
    /generate (bucket 1), a /generate_batch of each of `batch_sizes`, a
    16-bar /generate (a job in two 8-bar slices) and a primed /generate."""
    m = [compute_genre(i, cfg) for i in range(3)]
    out = {"solo": service.generate(mixture=m[0], bars=2, seed=7,
                                    temperature=0.9)}
    for b in batch_sizes:
        files = service.generate_batch([m[i % 3] for i in range(b)], bars=1,
                                       seed=3 + b)
        out.update({f"batch{b}_{i}": f for i, f in enumerate(files)})
    out["job"] = service.generate(mixture=m[1], bars=2 * service.slice_bars,
                                  seed=11)
    prime = _prime_roll(cfg)[:cfg.notes_per_bar]
    out["primed"] = service.generate(mixture=m[2], bars=1, seed=1,
                                     prime=prime)
    return out


def training_counts() -> Dict[str, int]:
    """Launches of the biaxial training kernels, and their plain
    versions' calls."""
    from music_generator_tpu_torch.ops import biax
    out = {}
    for kind in ("time", "note"):
        stack = getattr(biax, f"biax_{kind}_stack")
        out[f"biax_{kind}_fwd"] = stack.fwd_launches
        out[f"biax_{kind}_bwd"] = stack.bwd_launches
        out[f"biax_{kind}_plain"] = getattr(
            biax, f"biax_{kind}_stack_reference").calls
    return out


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in training_counts().items()}


def _train_weights(args, cfg):
    return (load_params_npz(args.train_params) if args.train_params
            else build_model(cfg, "cpu", seed=0).state_dict())


def notegen_launches() -> int:
    """Pitch-loop kernel launches on the card, plain-version calls on the
    CPU."""
    from music_generator_tpu_torch.ops import notegen
    return (notegen.note_sample.launches
            + notegen.note_sample_reference.calls)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_step(args, cfg, device, res: dict, arrays: dict) -> None:
    from music_generator_tpu_torch.parallel.train_step import (
        broadcast_state, create_train_state, train_step)
    ds = Dataset(*random_batch(cfg, batch_size=args.windows, seed=0))
    local = rank_rows(ds, "contiguous")
    batch = tuple(torch.from_numpy(a).to(device) for a in (
        local.notes, local.targets, local.beats, local.styles))
    model = build_model(cfg, device)
    state = create_train_state(model, 0)
    model.load_state_dict(_train_weights(args, cfg))
    broadcast_state(state)
    before = training_counts()
    metrics = train_step(state, batch)
    res["step_counts"] = _delta(before)
    res["step_loss"] = float(metrics["loss"])
    res["step_hash"] = param_hash(model)
    arrays.update(params_copy(model, "step."))
    if args.time_steps:
        _sync(device)
        t = time.perf_counter()
        for _ in range(args.time_steps):
            train_step(state, batch)
        _sync(device)
        res["step_ms"] = (time.perf_counter() - t) * 1e3 / args.time_steps
        grads = [torch.zeros_like(p) for p in model.parameters()]
        mesh.all_reduce_mean_(grads)            # warm-up
        _sync(device)
        t = time.perf_counter()
        for _ in range(args.time_steps):
            mesh.all_reduce_mean_(grads)
        _sync(device)
        res["all_reduce_ms"] = ((time.perf_counter() - t) * 1e3
                                / args.time_steps)
        res["bucket_floats"] = sum(g.numel() for g in grads)


def run_fit(args, cfg, device, res: dict, arrays: dict) -> None:
    from music_generator_tpu_torch.training.trainer import (TrainConfig,
                                                            Trainer)
    ds = Dataset(*random_batch(cfg, batch_size=args.windows, seed=0))
    local = rank_rows(ds, args.split)
    weights = _train_weights(args, cfg)
    res["fit"] = {}
    for i, mode in enumerate(args.fit_modes.split(",")):
        model = build_model(cfg, device)
        trainer = Trainer(model, TrainConfig(
            seed=0, checkpoint=False, tensorboard=False,
            epoch_scan_mode=mode,
            epoch_scan_max_bytes=args.max_bytes or (8 << 30)))
        model.load_state_dict(weights)
        hashes: List[str] = []
        trainer.state.optimizer.register_step_post_hook(
            lambda *_: hashes.append(param_hash(model)))
        before = training_counts()
        try:
            hist = trainer.fit(local, epochs=args.epochs)
        except ValueError as e:
            # Raised on every rank alike, before any step (a mode that
            # does not apply to this world).
            res["fit"][mode] = {"error": str(e)}
            continue
        out = {k: hist[k] for k in ("loss", "steps_per_epoch",
                                    "epoch_scan_mode", "batch_size")}
        out["hashes"] = hashes
        out["counts"] = _delta(before)
        if args.evaluate and i == 0:
            out["evaluate"] = trainer.evaluate(local)
        res["fit"][mode] = out
        arrays.update(params_copy(model, f"fit.{mode}."))


def run_generate(args, cfg, device, res: dict, arrays: dict) -> None:
    from music_generator_tpu_torch.generation.sampler import Sampler
    model = (build_model(cfg, device, state=load_params_npz(args.params))
             if args.params else build_model(cfg, device, seed=0))
    launches = notegen_launches()
    out = generation_cases(Sampler(model), cfg, args.gen.split(","))
    res["gen_launches"] = notegen_launches() - launches
    arrays.update({"gen." + k: v for k, v in out.items()})


def run_serve(args, cfg, device, res: dict, arrays: dict) -> None:
    from music_generator_tpu_torch.serving.multihost import (follow, lead,
                                                             shared_secret)
    from music_generator_tpu_torch.serving.server import GenerationService
    params = (load_params_npz(args.params) if args.params
              else build_model(cfg, "cpu", seed=0).state_dict())
    service = GenerationService(config=cfg, params=params, device=device,
                                max_batch=args.max_batch,
                                warmup_buckets=args.warmup_buckets)
    secret = shared_secret()
    launches = notegen_launches()
    if mesh.rank() != 0:
        res["replayed"] = follow(service, "127.0.0.1", args.serve_port,
                                 secret)
    else:
        proxy = lead(service, "127.0.0.1", args.serve_port,
                     mesh.world() - 1, secret)
        try:
            out = serving_requests(service, cfg, args.batch_sizes)
        finally:
            proxy.stop_followers()
        res["responses"] = {k: v.hex() for k, v in out.items()}
        res["device_calls"] = service.device_calls
    res["serve_launches"] = notegen_launches() - launches


MODES = {"step": run_step, "fit": run_fit, "generate": run_generate,
         "serve": run_serve}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("port", type=int)
    p.add_argument("out")
    p.add_argument("modes")
    p.add_argument("--device", default=None)
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    p.add_argument("--config", default="test", choices=["test", "default"])
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--no-dropout", action="store_true")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--params", default=None)
    p.add_argument("--train-params", default=None)
    p.add_argument("--windows", type=int, default=8)
    p.add_argument("--time-steps", type=int, default=0)
    p.add_argument("--split", default="shard",
                   choices=["shard", "contiguous"])
    p.add_argument("--fit-modes", default="sharded")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--max-bytes", type=int, default=0)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--gen", default="3x2s0")
    p.add_argument("--serve-port", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--warmup-buckets", type=int, default=1)
    p.add_argument("--batch-sizes", type=lambda s: [int(x) for x in
                                                    s.split(",")],
                   default=[4])
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    device = torch.device(args.device or (
        "cuda:0" if args.backend == "gloo" else f"cuda:{args.rank}"))
    mesh.init_distributed(args.rank, args.world,
                          f"tcp://127.0.0.1:{args.port}",
                          backend=args.backend, device=device)
    if device.type == "cuda":
        from music_generator_tpu_torch.device import full_f32
        torch.cuda.set_device(device)
        full_f32()
    overrides = {}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.no_dropout:
        overrides.update(dropout=0.0, input_dropout=0.0)
    base = test_config() if args.config == "test" else default_config()
    cfg = base.replace(out_dir=f"{args.out}.{args.rank}.out", **overrides)
    res: dict = {"rank": mesh.rank(), "world": mesh.world(),
                 "backend": torch.distributed.get_backend(),
                 "device": str(device)}
    arrays: dict = {}
    try:
        for mode in args.modes.split(","):
            MODES[mode](args, cfg, device, res, arrays)
        mesh.barrier()
    finally:
        mesh.destroy()
    np.savez(f"{args.out}.{args.rank}.npz", **arrays)
    with open(f"{args.out}.{args.rank}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
