"""The port's copy of the paper's analytical model (``repro_torch.core``:
``hardware``, ``workload``, ``xpu_sim``, ``scaling``, ``claims``) against
the reference's, in the same numpy arithmetic: for every config of the
port's registry on every catalog entry, ``simulate_vla``'s phase times and
bounds and ``workload_totals`` equal the reference's to 1e-12 relative;
``param_counts``, ``scaling_sweep`` and ``validate_all`` claim by claim
likewise; ``fleet_trace`` is the same trace for one seed, bit for bit."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.core import claims as RC
from repro.core import hardware as RH
from repro.core import scaling as RS
from repro.core import workload as RW
from repro.core import xpu_sim as RX
from repro_torch.configs import _MODULES, get_config
from repro_torch.core import claims as TC
from repro_torch.core import hardware as TH
from repro_torch.core import scaling as TS
from repro_torch.core import workload as TW
from repro_torch.core import xpu_sim as TX

REL = 1e-12


def close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def test_catalog_is_the_reference_catalog():
    assert list(TH.CATALOG) == list(RH.CATALOG)
    assert TH.TABLE1 == RH.TABLE1
    for name, hw in RH.CATALOG.items():
        assert dataclasses.asdict(TH.get_hardware(name)) == \
            dataclasses.asdict(hw)


@pytest.mark.parametrize("arch", sorted(_MODULES))
def test_simulate_vla_and_totals_match_reference(arch):
    """Every phase of the simulated step on every catalog entry, B = 1 and
    4: time (with and without prefetch), memory fraction and bound; the
    step's e2e and generation fraction; the workload's totals and each
    op's FLOPs and bytes; the config's parameter counts."""
    tcfg, rcfg = get_config(arch), ref_config(arch)
    assert tcfg.param_counts().keys() == rcfg.param_counts().keys()
    for k, v in rcfg.param_counts().items():
        assert close(tcfg.param_counts()[k], v), k
    for B in (1, 4):
        tph, rph = TW.build_vla_step(tcfg, B), RW.build_vla_step(rcfg, B)
        for k, v in RW.workload_totals(rph).items():
            assert close(TW.workload_totals(tph)[k], v), k
        assert [(o.name, o.kind) for p in tph for o in p.ops] == \
            [(o.name, o.kind) for p in rph for o in p.ops]
        for to, ro in zip((o for p in tph for o in p.ops),
                          (o for p in rph for o in p.ops)):
            assert close(to.flops, ro.flops) and close(to.bytes, ro.bytes)
        for name in RH.CATALOG:
            t = TX.simulate_vla(tcfg, TH.get_hardware(name), B)
            r = RX.simulate_vla(rcfg, RH.get_hardware(name), B)
            assert close(t.e2e, r.e2e) and \
                close(t.generation_fraction, r.generation_fraction)
            for tp, rp in zip(t.phases, r.phases):
                assert tp.name == rp.name and tp.bound == rp.bound
                for prefetch in (True, False):
                    assert close(tp.time(prefetch), rp.time(prefetch))
                assert close(tp.memory_fraction, rp.memory_fraction)


def test_scaling_sweep_matches_reference():
    for t, r in zip(TS.scaling_sweep(), RS.scaling_sweep()):
        fields = {f.name for f in dataclasses.fields(r)}
        assert {f: getattr(t, f) for f in fields
                if f not in ("vision", "action")} == \
            {f: getattr(r, f) for f in fields
             if f not in ("vision", "action")}
        assert close(t.param_counts()["total"], r.param_counts()["total"])
        assert close(TX.simulate_vla(t, TH.ORIN).e2e,
                     RX.simulate_vla(r, RH.ORIN).e2e)


def test_validate_all_matches_reference():
    tv, rv = TC.validate_all(), RC.validate_all()
    assert [c["claim"] for c in tv] == [c["claim"] for c in rv]
    for t, r in zip(tv, rv):
        assert t["ok"] == r["ok"] and t["expectation"] == r["expectation"]
        assert close(t["measured"], r["measured"]), t["claim"]
    assert all(c["ok"] for c in tv)


def test_fleet_trace_matches_reference():
    kw = dict(n_robots=6, steps_per_robot=4, seed=11)
    t, r = TW.fleet_trace(**kw), RW.fleet_trace(**kw)
    assert len(t) == len(r) == 24
    for a, b in zip(t, r):
        assert (a.t, a.robot, a.step, a.kind, a.max_tokens, a.deadline_s,
                a.priority) == (b.t, b.robot, b.step, b.kind, b.max_tokens,
                                b.deadline_s, b.priority)
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)
