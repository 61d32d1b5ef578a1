"""Faults planted under a run, for the tests that see `correct` come out
false, and the program's lower-precision paths that serve as controls.

Each `plant_<fault>(run)` takes a `TrainRun` after its set-up and breaks
the timed path underneath it; `unplant()` puts the program back.
"""

from __future__ import annotations

import torch

_undo: list = []  # callables that put the program back, last planted first


def _patch(obj, name, value):
    old = getattr(obj, name)
    _undo.append(lambda: setattr(obj, name, old))
    setattr(obj, name, value)


def unplant() -> None:
    while _undo:
        _undo.pop()()


def plant_unchanged(run) -> None:
    """A step that returns its state unchanged: the loss of the batch, no update."""
    import pointseg_torch.train.loop as loop
    from pointseg_torch.train.loss import masked_onehot_cross_entropy

    def step(state, points, labels, lengths):
        with torch.no_grad():
            state.model.train()
            logits = state.model(points, generator=state.generator)
            loss = masked_onehot_cross_entropy(logits, labels, lengths)
        return {"loss": loss, "accuracy": loss * 0, "miou": loss * 0}

    _patch(loop, "train_step", step)


def plant_half(run) -> None:
    """Half of the batch left out, the mean taken over the rest."""
    import pointseg_torch.train.loop as loop

    real = loop.train_step

    def step(state, points, labels, lengths):
        h = points.shape[0] // 2
        return real(state, points[:h], labels[:h], lengths[:h])

    _patch(loop, "train_step", step)


def plant_alter_logit(run) -> None:
    """An answer altered where it is produced: one logit of the forward's
    output moved by 1."""
    model = run.state.model

    def hook(module, inputs, output):
        output = output.clone()
        output[0, 0, 0] += 1.0
        return output

    _undo.append(model.register_forward_hook(hook).remove)


def plant_alter_row(run) -> None:
    """A row of a batch altered where the data layer produces it."""
    feed = run.feed
    inner = feed.loader

    class Altered:
        def __iter__(self):
            for points, labels, lengths in inner:
                points = points.clone() if isinstance(points, torch.Tensor) else points.copy()
                points[0, 0, 0] += 0.5
                yield points, labels, lengths

        def __len__(self):
            return len(inner)

    _patch(feed, "loader", Altered())


FAULTS = {"unchanged": plant_unchanged, "half": plant_half,
          "alter_logit": plant_alter_logit, "alter_row": plant_alter_row}

