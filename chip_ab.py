"""Compare two checkouts of the port on one GPU: outputs bit for bit, and
the per-axis training steps.

    python3 chip_ab.py OUT.json               # from a checkout's root
    python3 chip_ab.py --compare A.json B.json ...

The first form, run from the root of a checkout (with that root on
PYTHONPATH), hashes (sha256) the results of both biaxial forwards (the
tapes, and the note forward's output) and the outputs of both biaxial
backwards on seeded inputs at the training shapes:
bfloat16 at T = seq_len (the cluster scans) and float32 at T = CHECK_T
(the streamed scans); and, at the time and note axes' shapes in both
dtypes, the fused stack's forward (kernel 6: hs1, its tapes hs0, cs0,
cs1 and the four terminal states) and the recurrence's forward and
backward (kernels 8 and 9). It then times the axis-fused, per-layer and
3 + 3 layer routes' training step on fresh weights (seed 0) with
chip_smoke.py's `time_train_step`, and writes the hashes to OUT.json.
Run it in turns in two checkouts (parent, change, change, parent); the
second form prints whether each hash is equal across the files it is
given.  Needs a card.
"""

from __future__ import annotations

import hashlib
import json
import sys


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def axis_hashes(cfg) -> dict:
    """Kernel 6's outputs and tapes (through lstm2_stack's autograd
    Function, which saves them for its backward) and kernels 8 and 9's
    results, at the time and note axes' shapes (T = CHECK_T), on seeded
    inputs, bfloat16 and float32."""
    import torch
    import chip_smoke as cs
    from music_generator_tpu_torch.ops import lstm2, recurrence
    out = {}
    for axis, S, R, F, H in cs.axis_shapes(cfg, cs.CHECK_T):
        for cdt in (torch.bfloat16, torch.float32):
            args = [a.requires_grad_(True)
                    for a in cs.lstm_inputs("lstm2", S, R, F, H, 5)]
            hs1, fin = lstm2.lstm2_stack(
                *args, dropout_p=cfg.dropout, seed=99, compute_dtype=cdt,
                recurrent_activation="sigmoid")
            tapes = hs1.grad_fn.saved_tensors[-4:]
            out[f"lstm2_fwd {axis} {cdt}"] = digest((hs1, *fin, *tapes))
            xw, u, h0, c0 = cs.lstm_inputs("lstm_rec", S, R, F, H, 5)
            kw = dict(compute_dtype=cdt, recurrent_activation="sigmoid")
            fwd = recurrence.lstm_recurrence_fwd(xw, u, h0, c0, **kw)
            gen = torch.Generator("cuda").manual_seed(3)
            cots = [torch.randn(S, R, H, device="cuda", generator=gen),
                    torch.randn(R, H, device="cuda", generator=gen),
                    torch.randn(R, H, device="cuda", generator=gen)]
            bwd = recurrence.lstm_recurrence_bwd(xw, u, h0, fwd[0], fwd[1],
                                                 *cots, **kw)
            torch.cuda.synchronize()
            out[f"lstm_rec_fwd {axis} {cdt}"] = digest(fwd)
            out[f"lstm_rec_bwd {axis} {cdt}"] = digest(bwd)
    for key, value in out.items():
        cs.log(f"hash {key}: {value}")
    return out


def hashes() -> dict:
    import torch
    import chip_smoke as cs
    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.ops import biax
    cfg = default_config()
    out = axis_hashes(cfg)
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
            out[f"{kind} {cdt}"] = digest((*fwd, *got))
            cs.log(f"hash {kind} {cdt}: {out[f'{kind} {cdt}']}")
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
    for route in ("axis_fused", "per_layer", "depth_3_3"):
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
