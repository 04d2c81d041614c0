"""Where and why two generated .mid files diverge (the port of the JAX
package's tools/analyze_divergence.py): decode both to rolls, find the
first differing (timestep, pitch, channel), and, given the weights, replay
the prefix through the port's model to report how close the flipped draw's
probability sat to its uniform, or, for a volume byte, the head's distance
to the truncation boundary and the rounding midpoint.

    python -m music_generator_tpu_torch.tools.analyze_divergence A.mid B.mid \\
        [--params artifacts/trained_model_r4/params.npz --seed 0] \\
        [--style 0 | genre:N] [--stream-offset I] [--device cpu]

The replay forces file A's notes: `DeepJ.time_axis_step` each timestep,
`Sampler._chunk_uniforms` for the step's stream-indexed uniforms
(deviation #10), and at the diverging step `DeepJ.note_axis_cell` pitch by
pitch up to the flip, in float32 (the port's generation dtype), with the
adaptive-temperature bookkeeping of the sampler.  It runs on the card
unless --device cpu is given.  The printed lines are the JAX tool's.
`draw_margins` replays a whole file the same way and returns p - u of
every draw behind it, how far each sat from falling the other way."""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="First divergence of two .mid files, and how close "
                    "the flipped draw was")
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--params", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--style", default="0",
                        help="style of the analyzed stream: an int "
                             "(one-hot composer) or genre:N (uniform "
                             "genre mixture) — check_fidelity's "
                             "genres_<seed>_<i>.mid files use genre:<i>")
    parser.add_argument("--stream-offset", type=int, default=0,
                        help="the stream's GLOBAL index (deviation #10): "
                             "stream i of a batched run draws "
                             "fold_in(seed, i) uniforms — pass i when "
                             "analyzing file _<seed>_<i> of a batch")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np

    from music_generator_tpu_torch import midi
    from music_generator_tpu_torch.config import default_config

    cfg = default_config()
    ra = midi.midi_decode(midi.read_midifile(args.a), cfg.midi_max_notes)
    rb = midi.midi_decode(midi.read_midifile(args.b), cfg.midi_max_notes)
    T = min(len(ra), len(rb))
    diff = np.argwhere(ra[:T] != rb[:T])
    if len(diff) == 0 and len(ra) == len(rb):
        print("rolls identical")
        return
    if len(diff) == 0:
        print(f"rolls identical over common prefix; lengths {len(ra)} vs "
              f"{len(rb)}")
        return
    t0, pitch, ch = diff[0]
    names = {0: "play", 1: "replay", 2: "volume"}
    print(f"first divergence: t={t0}, midi pitch={pitch}, "
          f"channel={names[int(ch)]}: {ra[t0, pitch, ch]:.6f} vs "
          f"{rb[t0, pitch, ch]:.6f}")
    print(f"total differing cells: {len(diff)} "
          f"({len(diff) / ra[:T].size:.2%} of the roll — a single early "
          f"flip cascades through the autoregression)")

    if args.params is None:
        return

    import torch

    from music_generator_tpu_torch.data.dataset import (clamp_midi,
                                                        compute_genre)
    from music_generator_tpu_torch.device import resolve_device
    from music_generator_tpu_torch.generation.sampler import Sampler
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.params import load_params_npz
    from music_generator_tpu_torch.utils import one_hot

    dev = resolve_device(args.device)
    model = build_model(cfg.replace(compute_dtype=cfg.gen_dtype), dev,
                        state=load_params_npz(args.params))
    sampler = Sampler(model)
    if args.style.startswith("genre:"):
        style_vec = compute_genre(int(args.style.split(":", 1)[1]), cfg)
    else:
        style_vec = one_hot(int(args.style), cfg.num_styles)
    style = torch.as_tensor(np.stack([style_vec]), dtype=torch.float32,
                            device=dev)
    with torch.no_grad():
        _replay(model, sampler, style, clamp_midi(ra, cfg), ra, rb,
                int(t0), int(pitch), int(ch), args)


def forced_draws(model, sampler, style, notes, seed: int,
                 stream_offset: int, t_end: int, walk=lambda t: True):
    """Replay the clamped roll `notes` [T, N, 3] as the sampler drew it:
    the time axis fed the roll's notes at timesteps 0..t_end, and at each
    timestep where walk(t) the pitch recurrence fed the roll's previous
    pitch, yielding (t, n, pred [1, 3], tempered (play, replay)
    probabilities [1, 2], the draw's uniforms [2]) pitch by pitch, with
    the sampler's adaptive-temperature bookkeeping."""
    import torch

    from music_generator_tpu_torch.ops.sampling import apply_temperature

    dev = model.device
    style_emb = model.style_embedding(style)
    state = sampler._init_state(1, seed, 1.0, stream_offset)
    for t in range(t_end + 1):
        feats, time_state = model.time_axis_step(
            state.prev_note, sampler._beat_row(t, 1), style_emb,
            state.time_state)
        if walk(t):
            us = sampler._chunk_uniforms(state.stream_keys, t, 1)[0]
            note_state = model.init_note_state(1)
            prev = torch.zeros(1, 3, device=dev)
            for n in range(model.cfg.num_notes):
                pred, note_state = model.note_axis_cell(
                    feats[:, n], prev, style_emb, note_state)
                yield t, n, pred, apply_temperature(
                    pred[:, :2], state.temperature[:, None]), us[0, n]
                prev = torch.as_tensor(notes[t, n], dtype=torch.float32,
                                       device=dev)[None]
        row = torch.as_tensor(notes[t], dtype=torch.float32,
                              device=dev)[None]
        temperature, silent_time = sampler._temperature_update(state, row)
        state = state._replace(time_state=time_state, prev_note=row,
                               temperature=temperature,
                               silent_time=silent_time)


def draw_margins(model, sampler, style, notes, seed: int = 0,
                 stream_offset: int = 0):
    """p - u of every draw behind the clamped roll `notes`: the play draw
    of each pitch at each timestep ([T, N]; the note played where it is
    >= 0) and the replay draw of each played note (1-D).  |p - u| says how
    far a draw sat from falling the other way."""
    import numpy as np

    import torch

    T, N, _ = notes.shape
    play, replay = np.zeros((T, N)), []
    with torch.no_grad():
        for t, n, _, probs, u in forced_draws(model, sampler, style, notes,
                                              seed, stream_offset, T - 1):
            d = (probs[0] - u).cpu().numpy().astype(np.float64)
            play[t, n] = d[0]
            if notes[t, n, 0]:
                replay.append(d[1])
    return play, np.array(replay)


def _replay(model, sampler, style, notes, ra, rb, t0: int, pitch: int,
            ch: int, args) -> None:
    """Force file A's notes through the time axis up to t0, then walk the
    pitch recurrence at t0 up to the diverging pitch and print the flip."""
    import numpy as np

    n_clamped = pitch - model.cfg.min_note
    for t, n, pred, probs, us in forced_draws(
            model, sampler, style, notes, args.seed, args.stream_offset, t0,
            walk=lambda t: t == t0):
        if n < n_clamped:
            continue
        if ch == 2:
            # A volume byte: the raw head's distance to the int(vol * 127)
            # truncation boundary of raw copy-through and to the
            # round(vol * 127) midpoint of gen_volume_quantize.
            v = float(np.clip(float(pred[0, 2]), 0.0, 1.0))
            ka = int(round(float(ra[t0, pitch, 2]) * 127))
            kb = int(round(float(rb[t0, pitch, 2]) * 127))
            trunc = max(ka, kb) / 127
            mid = (ka + kb) / 2 / 127
            print(f"at the flip: raw volume head={v:.9f}, bytes {ka} vs "
                  f"{kb}; distance to truncation boundary {trunc:.9f}: "
                  f"{abs(v - trunc):.3e}; to rounding midpoint "
                  f"{mid:.9f}: {abs(v - mid):.3e} (ULP-scale drift across "
                  f"backends lands this byte differently)")
        else:
            u = float(us[ch])
            p = float(probs[0, ch])
            print(f"at the flip: {'play' if ch == 0 else 'replay'} "
                  f"prob={p:.9f} uniform={u:.9f} |p-u|={abs(p - u):.3e}")
        return


if __name__ == "__main__":
    main()
