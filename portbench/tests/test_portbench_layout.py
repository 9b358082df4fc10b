"""The benchmark's files are found by name, its generators are seeded, its
frozen counts reproduce the kernel bounds, its reference stands alone and
nothing it loads is JAX or the JAX package."""

import ast
import json
from pathlib import Path

import pytest
import torch

from portbench import generate, run
from portbench.counts import nn, schur, transport

HERE = Path(run.__file__).resolve().parent
BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


def test_every_file_is_found_by_name():
    for w in BENCH["workloads"]:
        c = run.cell(w["name"])
        assert (HERE / "loops" / f"{c.traffic['loop']}.py").is_file()
        loop = run.load_file(HERE / "loops" / f"{c.traffic['loop']}.py")
        for fn in ("setup", "step", "finish", "check", "control"):
            assert callable(getattr(loop, fn))
        assert c.end_to_end and c.per_layer, w["name"]
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert c.config["limits"] and all(v is not None for v in c.config["limits"].values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.load_file(HERE / "metrics" / f"{m['name']}.py").read), m["name"]
    for cfg in BENCH["configs"]:
        data = json.loads((run.ROOT / cfg["file"]).read_text())
        assert data["reduced"] == cfg["reduced"] and isinstance(data["assumed"], list)
        assert len(cfg["source"]) <= 200


def test_bal_track_lengths_are_exact():
    for name in ("ba-bal-venice1778",):
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        L, O = cfg["points"], cfg["observations"]
        g = generate.generator(2**31 + 7, "cpu")
        k = generate.track_lengths(L, O, cfg["min_track"], cfg["max_track"], g, "cpu")
        assert k.shape == (L,) and int(k.sum()) == O and int(k.min()) >= cfg["min_track"]
        assert int(k.max()) <= cfg["max_track"]
        assert abs(float(k.double().mean()) - O / L) < 1e-12


def _small_bal():
    cfg = json.loads((HERE / "configs" / "ba-bal-venice1778.json").read_text())
    return dict(cfg, cameras=60, points=2000, observations=10065)


def test_bal_instance_is_seeded_and_well_formed():
    cfg = _small_bal()
    a = generate.bal_instance(cfg, 3_000_000_001, "cpu")
    b = generate.bal_instance(cfg, 3_000_000_001, "cpu")
    c = generate.bal_instance(cfg, 3_000_000_002, "cpu")
    for key in ("cams0", "pts0", "pixels", "cam_idx", "pt_idx"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["pixels"], c["pixels"])
    assert a["cam_idx"].shape == (cfg["observations"],)
    counts = torch.bincount(a["pt_idx"], minlength=cfg["points"])
    assert int(counts.min()) >= 2 and int(counts.sum()) == cfg["observations"]
    assert bool((a["pt_idx"][1:] >= a["pt_idx"][:-1]).all())  # landmark order
    # a track is a run of neighbouring cameras
    first = torch.zeros(cfg["points"], dtype=torch.int64).scatter_reduce(0, a["pt_idx"], a["cam_idx"], "amin",
                                                                         include_self=False)
    assert torch.equal(a["cam_idx"] - first[a["pt_idx"]],
                       torch.arange(cfg["observations"]) - (torch.cumsum(counts, 0) - counts)[a["pt_idx"]])
    # every point lies in front of every camera that sees it
    from portbench.reference.ba import so3_exp

    cams, pts = a["cams_true"].double(), a["pts_true"].double()
    pc = (so3_exp(cams[:, 3:])[a["cam_idx"]] @ pts[a["pt_idx"]][:, :, None])[:, :, 0] + cams[a["cam_idx"], :3]
    assert float(pc[:, 2].min()) > 5.0


def test_scan_targets_are_seeded_with_the_same_transforms():
    cfg = json.loads((HERE / "configs" / "icp-fachada.json").read_text())
    cloud = torch.randn(500, 3)
    a, xa = generate.scan_targets(cloud, 16, cfg, 4_000_000_001)
    b, xb = generate.scan_targets(cloud, 16, cfg, 4_000_000_001)
    c, xc = generate.scan_targets(cloud, 16, cfg, 4_000_000_002)
    assert torch.equal(a, b) and torch.equal(xa, xb) and not torch.equal(a, c)
    assert torch.equal(torch.sort(xa[:, 0]).values, torch.sort(xc[:, 0]).values)  # same set, another order
    assert float(xa[:, :3].norm(dim=1).max()) <= cfg["max_translation_m"]
    assert float(xa[:, 3:].norm(dim=1).max()) <= cfg["max_rotation_rad"]


def test_the_scan_is_read_only_with_its_digest(tmp_path):
    from portbench.loops import scan

    cfg = json.loads((HERE / "configs" / "icp-fachada.json").read_text())
    assert scan.cloud(cfg, "cpu").shape == (cfg["points"], 3)
    changed = tmp_path / "fachada.txt"
    changed.write_text((scan.ROOT / cfg["cloud_file"]).read_text() + "0 0 0\n")
    with pytest.raises(SystemExit, match="SHA-256"):
        scan.cloud(dict(cfg, cloud_file=str(changed)), "cpu")


def test_frozen_counts_reproduce_the_kernel_bounds():
    # PERF.md §6: K5 0.103 ms at 29,310², K6 6.565 ms at 64 × 29,310², both
    # by operations; K11 at the headline (O = 500,000, C = 200, 3,010,270
    # slot pairs) 0.0097 ms of operations under its bytes.
    assert round(nn.search_bound_s(1, 29_310, 29_310) * 1e3, 3) == 0.103
    assert round(nn.search_bound_s(64, 29_310, 29_310) * 1e3, 3) == 6.565
    flops, n_bytes = schur.schur_build(3_010_270, 500_000, 200)
    assert round(flops / 67e12 * 1e3, 4) == 0.0097
    assert round(schur.schur_bound_s(3_010_270, 500_000, 200) * 1e3, 4) == round(n_bytes / 3.35e12 * 1e3, 4) == 0.0132
    # the transport: (P + 1)·n bytes, S's 5.76 MB over two processes
    assert round(transport.all_reduce_bound_s(5.76e6, 2) * 1e3, 5) == 0.00516


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= {"torch", "numpy", "math", "dataclasses", "portbench"}, (path, tops)
        assert all(n.startswith("portbench.reference") for n in _imports(path) if n.startswith("portbench")), path


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & set(run.FORBIDDEN), (path, tops & set(run.FORBIDDEN))


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys

    import moptimizer_0_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert "moptimizer_0_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.fake_submodule", object())
    assert "jax" in run.forbidden_modules()


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == "" and "needs" in out.err


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_parses(trace):
    c = run.cell("fachada.request")
    c.config.update(points=1200)
    c.traffic.update(pool=4, round=4, checked=3, trace_units=2)
    result = run.run_cell(c, 2**32 + 9, 0.3, trace, device="cpu", log=lambda s: None)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["checks"]["x_gap"]["limit"] == c.config["limits"]["x_gap"]
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= names
    assert ("icp.p50_ms" if trace else "icp_p95_ms") in line["metrics"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
