"""Compare two checkouts of the port on one GPU: outputs bit for bit, and
the per-axis training steps.

    python3 chip_ab.py OUT.json               # from a checkout's root
    python3 chip_ab.py --compare A.json B.json ...

The first form, run from the root of a checkout (with that root on
PYTHONPATH), hashes (sha256) the results of both biaxial forwards (the
tapes, and the note forward's output) and the outputs of both biaxial
backwards on seeded inputs at the training shapes:
bfloat16 at T = seq_len (the cluster scans) and float32 at T = CHECK_T
(the streamed scans). It then times the per-layer route's and the
3 + 3 layer stack's training step on fresh weights (seed 0) with
chip_smoke.py's `time_train_step`, and writes the hashes to OUT.json.
Run it in turns in two checkouts (parent, change, change, parent); the
second form prints whether each hash is equal across the files it is
given.  Needs a card.
"""

from __future__ import annotations

import hashlib
import json
import sys


def hashes() -> dict:
    import torch
    import chip_smoke as cs
    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.ops import biax
    cfg = default_config()
    out = {}
    for kind in ("time", "note"):
        for cdt, T in ((torch.bfloat16, cfg.seq_len),
                       (torch.float32, cs.CHECK_T)):
            args = cs.stack_inputs(kind, cfg, T, 5)
            kw = dict(dropout_p=cfg.dropout, seed=99, compute_dtype=cdt,
                      recurrent_activation="sigmoid")
            fwd = getattr(biax, f"biax_{kind}_fwd")(*args, **kw)
            tapes = fwd
            if kind == "note":
                tapes = fwd[1:]
                shape = (cfg.num_notes, T, cfg.batch_size, 3)
            else:
                shape = (T, cfg.num_notes, cfg.batch_size,
                         cfg.time_axis_units)
            cot = torch.randn(shape, device="cuda", generator=(
                torch.Generator("cuda").manual_seed(3)))
            got = getattr(biax, f"biax_{kind}_bwd")(*args, *tapes, cot, **kw)
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for t in (*fwd, *got):
                h.update(t.detach().contiguous().view(torch.uint8).cpu()
                         .numpy().tobytes())
            out[f"{kind} {cdt}"] = h.hexdigest()
            cs.log(f"hash {kind} {cdt}: {h.hexdigest()}")
    return out


def steps() -> None:
    import torch
    import chip_smoke as cs
    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.data.synth import random_batch
    from music_generator_tpu_torch.models.deepj import build_model
    cfg = default_config()
    card = cs.card_line()
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in random_batch(cfg, seed=0, rolled_targets=True))
    for route in ("per_layer", "depth_3_3"):
        rc = cfg.replace(**cs.ROUTES[route][0])
        cs.log(f"route {route}:")
        cs.time_train_step(rc, build_model(rc, "cpu", seed=0).state_dict(),
                           batch, card)


def main(argv) -> int:
    if argv[:1] == ["--compare"]:
        runs = [json.load(open(p)) for p in argv[1:]]
        for key in runs[0]:
            same = len({r[key] for r in runs}) == 1
            print(f"{key}: equal across {len(runs)} runs: {same}")
        return 0
    import torch
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__)
        return 2
    from music_generator_tpu_torch.device import full_f32
    full_f32()
    out = hashes()
    steps()
    with open(argv[0], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
