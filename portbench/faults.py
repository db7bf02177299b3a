"""Faults a serving cell can have, planted underneath the timed path.

Each takes `patch(owner, name, value)` (pytest's `monkeypatch.setattr`,
or `Patches` below) and the program's `Predictor` class, and breaks the
path a benchmark run drives; a run with one planted has to come out not
correct. One card: there is no exchange between cards to leave out.
`control.py --fault <name>` reads them on the card, the tests on the CPU.
"""

from __future__ import annotations

import numpy as np


def stale(patch, Predictor):
    """A step that returns its state unchanged: every request answered
    with the first request's answers."""
    orig, first = Predictor.predict_windows, {}

    def f(self, wins, valids, top_k=1):
        if "out" not in first:
            first["out"] = orig(self, wins, valids, top_k)
        return first["out"]
    patch(Predictor, "predict_windows", f)


def half(patch, Predictor):
    """Half of the batch left out, the mean taken over the rest."""
    orig = Predictor.predict_windows

    def f(self, wins, valids, top_k=1):
        h = len(wins) // 2
        out = orig(self, wins[:h], valids[:h], top_k)
        probs = np.concatenate([out["probs"], np.repeat(
            out["probs"].mean(0, keepdims=True), len(wins) - h, 0)])
        return self.finalize(probs, top_k)
    patch(Predictor, "predict_windows", f)


def rotated(patch, Predictor):
    """Answers returned for the wrong recordings (rows rotated by one)."""
    orig = Predictor.finalize
    patch(Predictor, "finalize", lambda self, probs, top_k=1:
          orig(self, np.roll(probs, 1, axis=0), top_k))


def altered(patch, Predictor):
    """Answers altered where they are produced: each answer's two likeliest
    classes swapped."""
    fin = Predictor.finalize

    def finalize(self, probs, top_k=1):
        probs = probs.copy()
        for row in probs:
            a, b = np.argsort(-row)[:2]
            row[a], row[b] = row[b], row[a]
        return fin(self, probs, top_k)
    patch(Predictor, "finalize", finalize)


FAULTS = {"stale": stale, "half": half, "rotated": rotated,
          "altered": altered}


class Patches:
    """setattr with undo, for a process that plants a fault and removes it."""

    def __init__(self):
        self._undo = []

    def __call__(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self._undo:
            owner, name, value = self._undo.pop()
            setattr(owner, name, value)
