"""orbit_compare.py's rule and records, and chip_smoke.py's orbit phase
(the port's side of the comparison on the card), on the CPU: no
subprocess, no card.

- ``compare`` gives each of its three verdicts on constructed samples;
- ``read_runs`` / ``summary`` keep the port's CPU records (``port``) and
  its card records (``port@cuda``) apart, pair ``port@cuda`` with the
  reference and with ``port`` at their common seeds only, and read the
  orbit phase's lines (its log and its runs.jsonl) and band_run lines;
- the orbit phase's configs are the ones ``write_config`` writes, for
  each scenario and route;
- ``orbit_runs/pr18_cpu.jsonl`` re-derives the verdicts that PERF.md
  quotes for those seeds.
"""
import json
import os
import sys

import numpy as np
import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import orbit_compare as OC  # noqa: E402


def _sample(mean, sd, n, seed):
    return list(np.random.default_rng(seed).normal(mean, sd, n))


@pytest.mark.parametrize("case", ["closed", "fault", "open"])
def test_compare_verdicts(case):
    b = _sample(1.5, 0.3, 20, 1)
    if case == "closed":
        a = _sample(1.5, 0.3, 20, 2)
    elif case == "fault":
        a = _sample(2.5, 0.3, 20, 2)
    else:
        a = _sample(1.8, 0.6, 6, 2)
        b = b[:6]
    r = OC.compare(a, b)
    assert r["verdict"] == case, r
    lo, hi = r["ci95_cm"]
    assert lo <= r["diff_cm"] <= hi
    assert r["diff_cm"] == pytest.approx(np.mean(a) - np.mean(b))
    if case == "closed":
        assert hi < OC.CLOSE_CM and r["seeds_a_side_to_decide"] is None
    elif case == "fault":
        assert lo > 0 and r["mannwhitney_p"] < 0.05
        assert r["seeds_a_side_to_decide"] is None
    else:
        # open, with more seeds a side than it has to decide it
        assert not hi < OC.CLOSE_CM
        assert not (lo > 0 and r["mannwhitney_p"] < 0.05)
        assert r["seeds_a_side_to_decide"] > len(a)


def test_compare_is_deterministic():
    a, b = _sample(1.7, 0.5, 16, 3), _sample(1.5, 0.5, 20, 4)
    assert OC.compare(a, b) == OC.compare(a, b)


def _rec(impl, seed, cm, route="fused", scenario="synth_tpu", **kw):
    return dict({"impl": impl, "scenario": scenario, "route": route,
                 "seed": seed, "rc": 0, "ate_rmse_m": cm / 100}, **kw)


def _write(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write((r if isinstance(r, str) else json.dumps(r)) + "\n")
    return str(path)


def test_sides_keep_cpu_and_card_records_apart(tmp_path):
    path = _write(tmp_path / "runs.jsonl", [
        _rec("port", 0, 1.0), _rec("port", 1, 1.1, device="cpu"),
        _rec("port", 0, 2.0, device="cuda"), _rec("reference", 0, 3.0),
        dict(_rec("port", 2, 1.0), ate_rmse_m=None, rc=1),
        '{"phase": "orbit"}', "not json", "[1, 2]"])
    rows = OC.read_runs([path])
    assert [r[2:] for r in rows] == [("port", 0, 1.0), ("port", 1, 1.1),
                                     ("port@cuda", 0, 2.0),
                                     ("reference", 0, 3.0)]
    assert OC.side({"impl": "port", "device": "cuda"}) == "port@cuda"
    assert OC.side({"impl": "reference"}) == "reference"


def _by_pair(lines):
    return {(r["compare"], r["scenario"], r["route_or_impl"],
             tuple(r["a_minus_b"])): r for r in lines}


def test_summary_pairs_the_card_with_the_reference_and_the_cpu(tmp_path):
    cpu = [_rec("port", s, 1.5 + 0.1 * s) for s in range(4)]
    ref = [_rec("reference", s, 1.4 + 0.05 * s) for s in range(2, 8)]
    card = [_rec("port", s, 1.6 + 0.07 * s, device="cuda")
            for s in range(1, 10)]
    card_plain = [_rec("port", s, 1.3 + 0.02 * s, route="plain",
                       device="cuda") for s in range(0, 5)]
    _write(tmp_path / "a.jsonl", cpu + ref)
    os.makedirs(tmp_path / "card" / "orbit")
    _write(tmp_path / "card" / "orbit" / "runs.jsonl", card + card_plain)
    got = _by_pair(OC.summary([str(tmp_path)]))
    ate = {(r["impl"] + ("@cuda" if "device" in r else ""), r["route"],
            r["seed"]): 100 * r["ate_rmse_m"]
           for r in cpu + ref + card + card_plain}

    def check(key, a, b, seeds):
        r = got.pop(key)
        assert r["seeds"] == seeds
        want = OC.compare([ate[(a, key[2], s)] for s in seeds],
                          [ate[(b, key[2], s)] for s in seeds])
        assert {k: r[k] for k in want} == want

    check(("packages", "synth_tpu", "fused", ("port", "reference")),
          "port", "reference", [2, 3])
    check(("packages", "synth_tpu", "fused", ("port@cuda", "reference")),
          "port@cuda", "reference", [2, 3, 4, 5, 6, 7])
    check(("packages", "synth_tpu", "fused", ("port@cuda", "port")),
          "port@cuda", "port", [1, 2, 3])
    r = got.pop(("routes", "synth_tpu", "port@cuda", ("fused", "plain")))
    assert r["seeds"] == [1, 2, 3, 4]
    want = OC.compare([ate[("port@cuda", "fused", s)] for s in r["seeds"]],
                      [ate[("port@cuda", "plain", s)] for s in r["seeds"]])
    assert {k: r[k] for k in want} == want
    # nothing else: the plain route has no CPU side, no reference
    assert not got, sorted(got)


def test_summary_reads_the_orbit_phase_and_band_lines(tmp_path, capsys,
                                                      monkeypatch):
    """run_orbit on a stand-in for run_slam (the card's run): its printed
    records and its runs.jsonl are read as port@cuda's, beside band_run
    lines of the same log; the route's kernels reach run_slam."""
    calls = []

    def fake_run_slam(out_dir, name, tag="", spec=None, seed=None,
                      max_ate=None):
        calls.append((name, tag, spec, seed, max_ate))
        route = "fused" if spec[1]["model"]["fused_mlp"] else "plain"
        assert spec[2:] == chip_smoke.ORBIT_KERNELS[route]
        launches = {"topk_rows": 100 + seed}
        return ({"ate_rmse_m": 0.01 + 0.001 * seed
                 + (0.002 if route == "plain" else 0), "track_ms_mean": 1.0,
                 "map_ms_mean": 2.0, "n_frames": 15,
                 "launches": launches}, None)

    monkeypatch.setattr(chip_smoke, "run_slam", fake_run_slam)
    out = tmp_path / "smoke"
    res = chip_smoke.run_orbit(str(out), seeds=(0, 1, 2),
                               scenarios=("synth_tpu",),
                               routes=("fused", "plain"))
    assert res["runs"] == 6 and len(calls) == 6
    assert all(c[0] == "orbit" and c[4] is None for c in calls)
    assert [c[3] for c in calls] == [0, 1, 2, 0, 1, 2]
    printed = capsys.readouterr().out
    recs = [json.loads(line) for line in printed.splitlines()]
    assert all(r["impl"] == "port" and r["device"] == "cuda"
               and r["launches"] == {"topk_rows": 100 + r["seed"]}
               and r["n_frames"] == 15 for r in recs)
    with open(out / "orbit" / "runs.jsonl") as f:
        assert [json.loads(line) for line in f] == recs
    band = [{"band_run": {"config": "synth_tpu", "path": p, "seed": s,
                          "ate_cm": 1.0 + s + (0.1 if p == "slam" else 0)}}
            for p in ("slam", "slam_fused") for s in (0, 1)]
    log = _write(tmp_path / "smoke.log",
                 ['{"phase": "orbit", "start": true}'] + printed.splitlines()
                 + [json.dumps(b) for b in band])
    ref = _write(tmp_path / "ref.jsonl",
                 [_rec("reference", s, 1.2, route=r) for s in (0, 1, 2)
                  for r in ("fused", "plain")])
    for paths in ([log, ref], [str(out), ref]):
        got = _by_pair(OC.summary(paths))
        for route in ("fused", "plain"):
            assert got[("packages", "synth_tpu", route,
                        ("port@cuda", "reference"))]["seeds"] == [0, 1, 2]
        r = got[("routes", "synth_tpu", "port@cuda", ("fused", "plain"))]
        assert r["diff_cm"] == pytest.approx(-0.2)
        assert (("packages", "band:synth_tpu", None, ("slam_fused", "slam"))
                in got) == (paths[0] == log)


@pytest.mark.parametrize("route", ["fused", "plain"])
@pytest.mark.parametrize("scenario", ["synth_tpu", "synth_quality"])
def test_orbit_configs_are_write_configs(tmp_path, scenario, route):
    """The config the orbit phase runs (run_slam's, from orbit_spec) loads
    to the one orbit_compare.py's runs load, but for the output folder
    and the quiet flag; each route's kernels are the route's."""
    from hpslam_tpu_torch import config as C
    seed = 7
    ref_path = str(tmp_path / "oc.yaml")
    OC.write_config(ref_path, scenario, seed, str(tmp_path / "out"),
                    route=route)
    spec = chip_smoke.orbit_spec(scenario, route, seed)
    smoke_path = str(tmp_path / "smoke.yaml")
    with open(smoke_path, "w") as f:
        yaml.safe_dump(chip_smoke.slam_config(spec, seed), f)
    want = C.load_config(ref_path, C.default_config_path())
    got = C.load_config(smoke_path, C.default_config_path())
    assert got.pop("verbose") is False
    want.pop("verbose", None)
    assert want["data"].pop("output") == str(tmp_path / "out")
    got["data"].pop("output", None)
    # the same base: relative to the repo's root, or absolute
    assert os.path.join(ROOT, want.pop("inherit_from")) == \
        got.pop("inherit_from")
    assert got == want
    assert got["seed"] == seed
    assert got["model"]["fused_mlp"] is (route == "fused")
    assert got["synthetic"]["n_frames"] == (15 if scenario == "synth_tpu"
                                            else 120)
    assert spec[2:] == chip_smoke.ORBIT_KERNELS[route]


def test_pr18_records_give_pr18_verdicts():
    """orbit_runs/pr18_cpu.jsonl (PR 18's CPU seeds as PERF.md lists
    them) re-derives the verdicts PERF.md quotes for them."""
    path = os.path.join(ROOT, "orbit_runs", "pr18_cpu.jsonl")
    got = _by_pair(OC.summary([path]))
    want = {("packages", "synth_tpu", "fused", ("port", "reference")):
            (16, 0.222, -0.127, 0.590, 0.396, 42),
            ("packages", "synth_tpu", "plain", ("port", "reference")):
            (7, 0.117, -0.198, 0.448, 0.62, 14),
            ("routes", "synth_tpu", "reference", ("fused", "plain")):
            (7, -0.043, -0.533, 0.486, None, None),
            ("routes", "synth_tpu", "port", ("fused", "plain")):
            (7, 0.298, -0.244, 0.859, None, None)}
    assert set(got) == set(want)
    for key, (n, diff, lo, hi, p, seeds) in want.items():
        r = got[key]
        assert r["verdict"] == "open" and len(r["seeds"]) == n
        assert round(r["diff_cm"], 3) == diff
        assert [round(x, 3) for x in r["ci95_cm"]] == [lo, hi]
        if p is not None:
            assert round(r["mannwhitney_p"], 3) == p
            assert r["seeds_a_side_to_decide"] == seeds
