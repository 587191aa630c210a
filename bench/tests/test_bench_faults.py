"""``correct`` comes out false when the timed path is broken underneath:
each run below skips the look for a card, drives a whole run of the cell
at a small size on the CPU, with one fault planted in the program, and
must read a number past its limit. A served model's cells can have three
of the faults (one chip: no exchange between chips to leave out)."""
import pytest
import torch

from conftest import shrink
from harness import manifest as MF
from harness.run_cell import run

CELLS = [w["name"] for w in MF.load()["workloads"]]
SEED = 2 ** 32 + 77


def _cache_unchanged(monkeypatch):
    """A decode step leaves the cache as it found it."""
    from repro_torch.models import layers as L
    chunk, paged = L.update_cache_chunk, L.update_cache_paged

    def update_cache_chunk(cache, new, *a, **k):
        if new.shape[1] != 1:
            return chunk(cache, new, *a, **k)
    monkeypatch.setattr(L, "update_cache_chunk", update_cache_chunk)
    monkeypatch.setattr(L, "update_cache_paged", lambda *a, **k: None)
    assert paged is not None


def _half_batch(monkeypatch):
    """A decode step computes half of the batch (the even rows) and hands
    its rows to the other half."""
    from repro_torch.models import model as M
    step = M.decode_step

    def decode_step(*a, **k):
        logits, caches = step(*a, **k)
        out = logits.clone()
        odd = out[1::2]
        odd.copy_(logits[0::2][:odd.shape[0]])
        return out, caches
    monkeypatch.setattr(M, "decode_step", decode_step)


def _token_altered(monkeypatch):
    """The decode step's token is altered where it is produced: the next
    id after the best."""
    from repro_torch.models import model as M
    step = M.decode_step

    def decode_step(*a, **k):
        logits, caches = step(*a, **k)
        return logits.roll(1, dims=-1), caches
    monkeypatch.setattr(M, "decode_step", decode_step)


def _trajectory_altered(monkeypatch):
    """The DiT head's answer is altered where it is produced."""
    from repro_torch.models import model as M
    loop = M.DiTGraph.run

    def run_(self, *a, **k):
        return loop(self, *a, **k) * 1.05
    monkeypatch.setattr(M.DiTGraph, "run", run_)


FAULTS = {"cache_unchanged": _cache_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered,
          "trajectory_altered": _trajectory_altered}


def _cases():
    for cell in CELLS:
        for name in FAULTS:
            if name == "trajectory_altered" and "dit" not in cell:
                continue
            yield cell, name


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run(cell, SEED, 0.3, False, device="cpu", adjust=shrink)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values()) \
        or r["failed"], r
