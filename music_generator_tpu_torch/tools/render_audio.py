"""Render .mid samples to 16-bit 22050 Hz mono .wav files (the JAX package's
tools/render_audio.py): a deterministic additive piano synthesizer on the
port's own codec (decode -> piano roll -> waveform).

    python -m music_generator_tpu_torch.tools.render_audio a.mid [b.mid ...]
    python -m music_generator_tpu_torch.tools.render_audio --all-artifacts

Each note is a struck string: stretched partials (f_h = h f0 sqrt(1 + B h^2),
B growing toward the treble), two or three slightly detuned unison strings
that beat, a fast hammer stage decaying into a slow sustain with extra
damping on the high partials and velocity-dependent brightness, and a few
ms of hammer noise.  The dry mix is convolved (by FFT) with a short
decaying noise impulse response, a soundboard stand-in.

All randomness (partial phases, hammer noise, the impulse response) comes
from generators seeded 12345 and 777 and drawn in iteration order, and the
arithmetic is the JAX tool's operation for operation in float64, so a .mid
renders to the same bytes as the JAX tool writes.  It runs on the host: no
kernel, no card.
"""

from __future__ import annotations

import argparse
import glob
import os
import wave
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SAMPLE_RATE = 22050
# One 16th-note step of the codec's grid: the encoder writes
# resolution=NOTES_PER_BEAT with no tempo event, so players assume 120 bpm
# (a beat 0.5 s, a 16th 0.125 s).
STEP_SECONDS = 0.125
MAX_PARTIALS = 14


def _note_signal(freq: float, vel: float, dur: int, n: int, sr: int,
                 rng: np.random.Generator) -> np.ndarray:
    """One struck note of `n` samples, released after `dur`: stretched,
    beating partials under a dual-stage velocity-bright envelope, with a
    hammer-noise attack."""
    t = np.arange(n) / sr
    # Dual-stage decay, both stages faster toward the treble.
    k_fast = 7.0 + freq / 180.0
    k_slow = 0.55 + freq / 650.0
    env = 0.9 * np.exp(-k_fast * t) + 0.75 * np.exp(-k_slow * t)
    rel = np.ones(n)
    if n > dur:
        rel[dur:] = np.exp(-13.0 * (np.arange(n - dur) / sr))
    # String inharmonicity.
    B = 1.1e-4 * (freq / 261.63) ** 0.7
    # Harder strikes excite the upper partials more.
    bright = 0.45 + 0.52 * min(vel, 1.0)
    # Unison detune (Hz): three strings below 1100 Hz, two above.
    detunes = (0.0, 0.22, -0.27) if freq < 1100.0 else (0.0, 0.14)
    sig = np.zeros(n)
    for h in range(1, MAX_PARTIALS + 1):
        f = freq * h * float(np.sqrt(1.0 + B * h * h))
        if f >= 0.47 * sr:
            break
        amp = h ** -1.6 * bright ** (h - 1)
        if amp < 2e-4:
            break
        # High partials damp faster than the fundamental.
        damp = np.exp(-0.55 * (h - 1) * t) if h > 1 else 1.0
        ph = rng.uniform(0.0, 2.0 * np.pi)
        partial = np.zeros(n)
        for d in detunes:
            partial += np.sin(2.0 * np.pi * (f + d * (1.0 + 0.25 * h)) * t
                              + ph)
        sig += (amp / len(detunes)) * partial * damp
    # Hammer contact noise: a few ms, brighter and louder with velocity.
    nh = min(n, int(0.006 * sr))
    noise = rng.standard_normal(nh) * np.exp(-np.arange(nh)
                                             / (0.0012 * sr))
    sig[:nh] += 0.12 * vel * noise
    return sig * env * rel


def render_roll(roll: np.ndarray, sr: int = SAMPLE_RATE) -> np.ndarray:
    """[T, 128, 3] (play, replay, volume) piano roll -> float64 waveform in
    [-1, 1], with a 2 s tail after the last step."""
    T = roll.shape[0]
    step = int(round(STEP_SECONDS * sr))
    tail = int(2.0 * sr)
    total = T * step + tail
    out = np.zeros(total, np.float64)
    rng = np.random.default_rng(12345)

    play, replay, volume = roll[..., 0], roll[..., 1], roll[..., 2]
    for pitch in range(128):
        p_col = play[:, pitch]
        if not p_col.any():
            continue
        # Onsets: 0 -> 1 play transitions, and replays while held (the
        # codec's NoteOff + NoteOn pair).
        prev = np.concatenate([[0.0], p_col[:-1]])
        onsets = np.flatnonzero(((p_col > 0) & (prev == 0))
                                | ((replay[:, pitch] > 0) & (p_col > 0)))
        if not len(onsets):
            continue
        freq = 440.0 * 2.0 ** ((pitch - 69) / 12.0)
        for t0 in onsets:
            # A note ends at its release or at the next re-articulation.
            t_end = t0 + 1
            while t_end < T and p_col[t_end] > 0 and \
                    not (replay[t_end, pitch] > 0):
                t_end += 1
            vel = float(volume[t0, pitch])
            if vel <= 0:
                continue
            dur = (t_end - t0) * step
            n = dur + int(1.6 * sr)            # ring past the release
            seg = _note_signal(freq, vel, dur, n, sr, rng)
            start = t0 * step
            out[start:start + n] += (0.16 * vel) * seg[:max(0,
                                                            total - start)]

    # Soundboard: convolve the dry mix with a smoothed, exponentially
    # decaying noise impulse response.
    ir_n = int(0.30 * sr)
    ir_rng = np.random.default_rng(777)
    ir = ir_rng.standard_normal(ir_n) * np.exp(-np.arange(ir_n)
                                               / (0.055 * sr))
    kernel = np.ones(8) / 8.0
    ir = np.convolve(ir, kernel, mode="same")
    ir[0] = 0.0
    m = total + ir_n
    nfft = 1 << int(np.ceil(np.log2(m)))
    wet = np.fft.irfft(np.fft.rfft(out, nfft) * np.fft.rfft(ir, nfft),
                       nfft)[:total]
    wet_gain = 0.035
    out = out + wet_gain * wet

    peak = np.abs(out).max()
    if peak > 0.98:
        out *= 0.98 / peak
    return out


def write_wav(path: str, signal: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """Write `signal` in [-1, 1] as 16-bit little-endian mono PCM."""
    pcm = np.clip(signal * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def render_file(mid_path: str, wav_path: Optional[str] = None) -> str:
    """Decode and render one .mid to `wav_path` (default: beside it, .wav).
    Re-strikes that the decode suppresses (an encoder-written file carries
    them as same-instant off + on pairs on the frame grid) are read at the
    event level by `analysis.event_replays` and unioned into the replay
    channel; where the decode already sees them the union changes
    nothing."""
    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.data.analysis import event_replays
    from music_generator_tpu_torch.midi import midi_decode, read_midifile

    cfg = default_config()
    pattern = read_midifile(mid_path)
    roll = midi_decode(pattern, cfg.midi_max_notes, config=cfg)
    for frame, pitch in event_replays(pattern, config=cfg):
        if frame < len(roll) and roll[frame, pitch, 0] > 0:
            roll[frame, pitch, 1] = 1.0
    wav_path = wav_path or os.path.splitext(mid_path)[0] + ".wav"
    write_wav(wav_path, render_roll(roll))
    print("rendered", wav_path)
    return wav_path


ARTIFACT_SETS = (
    "artifacts/long_samples_r3/*.mid",
    "artifacts/long_samples_r4/*.mid",
    "artifacts/short_samples_r2/*.mid",
    "artifacts/short_samples_r4/*.mid",
    "artifacts/real_corpus_r3/*.mid",
    "artifacts/primed_demos_r4/*.mid",
)


def main(argv=None) -> list:
    """Render each path (or every committed sample set beside its .mid);
    returns the .wav paths written."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("paths", nargs="*")
    parser.add_argument("--all-artifacts", action="store_true",
                        help="render every committed sample set next to "
                             "its .mid")
    args = parser.parse_args(argv)
    paths = list(args.paths)
    if args.all_artifacts:
        for pat in ARTIFACT_SETS:
            paths.extend(sorted(glob.glob(os.path.join(REPO, pat))))
    if not paths:
        parser.error("give .mid paths or --all-artifacts")
    return [render_file(p) for p in paths]


if __name__ == "__main__":
    main()
