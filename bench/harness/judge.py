"""The comparison that decides ``correct``: what the timed path served,
held to the plain float32 reference (``reference/``), run once the window
has closed on the same weights and inputs.

- ``logit_gap``: for every served token, how far its reference logit lies
  below the reference's best logit at that position, teacher-forced on the
  served tokens; the widest gap is compared. Greedy decoding serves the
  argmax, so a sound bf16 program only loses near-ties.
  ``logit_gap_mean`` is the same gap's mean over the positions.
- ``trajectory_err``: the DiT head's trajectory against the reference's
  from the same noise and condition: the largest absolute difference over
  the largest absolute reference value.

Each reading is taken for every mode of ``modes``: None reads the
program's tokens and trajectory; a precision of the reference ("fp8",
"fp8w") reads what that control would have served in the program's place
(the token it puts first at each position; its trajectory), under the
name with ``/<mode>`` at its end."""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from reference import molmoact as R  # noqa: E402


def suffix(mode) -> str:
    return "" if mode is None else "/" + mode


def token_readings(w, cfg, tokens, patches, served,
                   modes=(None,)) -> dict:
    """``logit_gap`` and ``logit_gap_mean`` of each mode."""
    if not modes:
        return {}
    ref = R.served_logits(w, cfg, tokens, patches, served)
    best = ref.max(-1).values
    out = {}
    for mode in modes:
        pick = served if mode is None else R.served_logits(
            w, cfg, tokens, patches, served, quant=mode).argmax(-1)
        if int(pick.min()) < 0 or int(pick.max()) >= ref.shape[-1]:
            big, mean = float("inf"), float("inf")
        else:
            gap = best - ref.gather(-1, pick[..., None])[..., 0]
            big, mean = float(gap.max()), float(gap.mean())
        out["logit_gap" + suffix(mode)] = big
        out["logit_gap_mean" + suffix(mode)] = mean
    return out


def trajectory_readings(w, cfg, cond, noise, traj, modes=(None,)) -> dict:
    """``trajectory_err`` of each mode."""
    if not modes:
        return {}
    ref = R.trajectory(w, cfg, cond, noise)
    out = {}
    for mode in modes:
        got = traj if mode is None else R.trajectory(w, cfg, cond, noise,
                                                     quant=mode)
        err = (got.float() - ref).abs().max() / ref.abs().max()
        out["trajectory_err" + suffix(mode)] = (
            float(err) if bool(got.isfinite().all()) else float("inf"))
    return out
