"""The port's versioned scenario registry (``repro_torch.sim.registry``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_registry.py``.  The port's goldens are
byte-identical copies of the JAX package's; every one of the 13
registered refs (the three live replays of ``tests/golden/`` and the
autoscaled diurnal fleet included) gives the same ``golden_record`` in
both packages and passes the port's ``check``.  Records are JSON: the
tolerance is bit-equality.
"""
import json
import pathlib

import pytest

from repro.sim import registry as jreg
from repro_torch.sim import Scenario, Straggler
from repro_torch.sim import registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFS = jreg.names()


def test_refs_equal_jax():
    assert registry.names() == REFS and len(REFS) == 13
    for ref in REFS:
        t, j = registry.entry(ref), jreg.entry(ref)
        assert (t.description, t.tags, t.grid is None) == \
            (j.description, j.tags, j.grid is None), ref


@pytest.mark.parametrize("name", ["registry.json", "serve_flip_min.json"])
def test_goldens_byte_identical_to_jax(name):
    got = (ROOT / "src" / "repro_torch" / "sim" / "goldens" / name)
    want = (ROOT / "src" / "repro" / "sim" / "goldens" / name)
    assert got.read_bytes() == want.read_bytes()
    assert registry.GOLDEN_DIR == got.parent
    assert registry._TRACE_DIR == ROOT / "tests" / "golden"


@pytest.mark.parametrize("ref", REFS)
def test_golden_record_equals_jax(ref):
    assert registry.golden_record(ref) == jreg.golden_record(ref)


def test_check_green_over_every_ref():
    assert registry.check() == []


def test_every_ref_loads_a_fresh_unbuilt_simulation():
    for ref in registry.names():
        sim = registry.load(ref)
        assert sim.topology.n_hosts >= 1 and not sim._built
        assert registry.load(ref) is not sim


def test_bare_name_resolves_latest_version(monkeypatch):
    monkeypatch.setitem(registry._REGISTRY, "tmp_scn", {})
    registry.register("tmp_scn", 1, "v1", lambda s=None: None)
    registry.register("tmp_scn", 3, "v3", lambda s=None: None)
    registry.register("tmp_scn", 2, "v2", lambda s=None: None)
    assert registry.entry("tmp_scn").version == 3
    assert registry.entry("tmp_scn@v2").version == 2
    assert registry.entry("tmp_scn@v3").ref == "tmp_scn@v3"


def test_duplicate_registration_rejected(monkeypatch):
    monkeypatch.setitem(registry._REGISTRY, "tmp_dup", {})
    registry.register("tmp_dup", 1, "first", lambda s=None: None)
    with pytest.raises(ValueError, match="new version"):
        registry.register("tmp_dup", 1, "again", lambda s=None: None)


def test_unknown_refs_error_with_available_names():
    with pytest.raises(KeyError, match="registered:"):
        registry.entry("no_such_scenario")
    with pytest.raises(KeyError, match="no version v9"):
        registry.entry("serve_smoke@v9")
    with pytest.raises(KeyError, match="name@vN"):
        registry.entry("serve_smoke@latest")


def test_campaign_bases_accept_scenario_override():
    sc = Scenario("probe", (Straggler("serve.client0", 2.0),))
    sim = registry.load("serve_smoke@v1", scenario=sc)
    assert sim.scenario.name == "probe"
    assert registry.entry("serve_smoke@v1").grid().n_points == 16


def test_pinned_live_entries_reject_scenario_override():
    with pytest.raises(ValueError, match="pins its scenario"):
        registry.load("live_recovery@v1", scenario=Scenario("x"))


def test_golden_check_flags_drift(tmp_path, monkeypatch):
    golden = json.loads(registry.GOLDEN.read_text())
    golden["rack_ring@v1"]["canonical"]["vtime_ns"] += 1
    fake = tmp_path / "registry.json"
    fake.write_text(json.dumps(golden))
    monkeypatch.setattr(registry, "GOLDEN", fake)
    failures = registry.check(["rack_ring@v1"])
    assert len(failures) == 1 and "rack_ring@v1" in failures[0]


def test_cli_list_json_equals_jax(capsys):
    assert registry.main(["list", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert jreg.main(["list", "--json"]) == 0
    assert rows == json.loads(capsys.readouterr().out)
    by_ref = {r["ref"]: r for r in rows}
    assert by_ref["rack_ring@v1"]["campaign_base"] is True
    assert by_ref["diurnal_autoscale@v1"]["tags"] == ["gallery", "control"]


def test_cli_check_exit_codes(tmp_path, monkeypatch, capsys):
    golden = json.loads(registry.GOLDEN.read_text())
    golden["rack_ring@v1"]["canonical"]["messages"] += 1
    fake = tmp_path / "registry.json"
    fake.write_text(json.dumps(golden))
    monkeypatch.setattr(registry, "GOLDEN", fake)
    assert registry.main(["check", "rack_ring@v1"]) == 1
    assert "FAIL rack_ring@v1" in capsys.readouterr().out
    monkeypatch.undo()
    assert registry.main(["check", "rack_ring@v1"]) == 0
    assert "1 refs, 0 failures" in capsys.readouterr().out


def test_diurnal_autoscale_record_pins_control_plane():
    rec = registry.golden_record("diurnal_autoscale@v1")
    assert rec["outcome"] == "ok"
    sec = rec["canonical"]["control"]["autoserve"]
    moves = [(d["from"], d["to"]) for d in sec["decisions"]
             if d["from"] != d["to"]]
    assert moves == [(4, 8), (8, 16), (16, 32), (32, 64),
                     (64, 32), (32, 16), (16, 8), (8, 4)]
    assert sec["peak_active"] == 64 and sec["final_active"] == 4
    joins = [e for e in rec["canonical"]["control"]["membership"]
             if e["event"] == "join"]
    assert len(joins) == 60


def test_campaign_derived_entry_reproduces_the_crash():
    rec = registry.golden_record("serve_flip_min@v1")
    assert rec["outcome"] == "crash"
    assert "unknown endpoint" in rec["detail"]
