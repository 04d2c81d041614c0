"""A run with the timed path broken underneath comes out not correct, by
the cells' own limits: on the CPU at test widths, through everything of
a run but the look for a card."""

import pytest
import torch

from portbench.tests import helpers

TRAIN_CELLS = [c for c in helpers.CELLS
               if helpers.files(c)["traffic"]["driver"] == "train"]
GEN_CELLS = [c for c in helpers.CELLS
             if helpers.files(c)["traffic"]["driver"] in ("generate",
                                                          "serve")]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from music_generator_tpu_torch.ops.nadam import Nadam
    real = Nadam.step

    def unchanged(self, closure=None):
        """Nadam's moments move; the parameters are put back."""
        params = [p for g in self.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        real(self, closure)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
    monkeypatch.setattr(Nadam, "step", unchanged)
    res = helpers.execute(name)
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_half_of_the_batch_left_out(name, monkeypatch):
    """The loss is the mean over the first half of the rows."""
    from music_generator_tpu_torch.models import deepj
    real = deepj.primary_loss

    def half(y_true, y_pred):
        h = y_true.shape[0] // 2
        return real(y_true[:h], y_pred[:h])
    monkeypatch.setattr(deepj, "primary_loss", half)
    res = helpers.execute(name)
    assert res["correct"] is False


@pytest.mark.parametrize("name", GEN_CELLS)
def test_note_altered_where_produced(name, monkeypatch):
    """One draw of every stream flipped where the sampler assembles the
    notes (a generated piece, or a served one before it is encoded)."""
    from music_generator_tpu_torch.generation.sampler import Sampler
    real = Sampler._assemble

    def altered(self, pr, vol):
        notes = real(self, pr, vol)
        t, n = 0, 20
        notes[:, t, n, 0] = 1.0 - notes[:, t, n, 0]
        notes[:, t, n, 1] *= notes[:, t, n, 0]
        notes[:, t, n, 2] = 0.5 * notes[:, t, n, 0]   # a velocity to write
        return notes
    monkeypatch.setattr(Sampler, "_assemble", altered)
    res = helpers.execute(name)
    assert res["correct"] is False
    assert res["checks"]["draw_gap"]["value"] > \
        res["checks"]["draw_gap"]["limit"]
