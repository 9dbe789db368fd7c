"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the meta
device: qwen2-7b over every shape on the production 16 x 16 mesh and on a
2 x 4 override, every record ``ok`` with the JAX record's keys; a cell that
fails is recorded with ``status: "error"`` and the run exits 1; the
abstract meshes it runs on."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.sharding.collectives import AbstractGroup  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"arch", "shape", "mesh", "mesh_shape", "devices", "plan", "status", "memory",
        "fits_hbm", "collective_detail", "roofline", "cost", "trace_s"}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _records(out):
    return {p.stem: json.loads(p.read_text()) for p in sorted(Path(out).glob("*/*.json"))}


@pytest.mark.parametrize("argv,mesh_shape", [
    ([], {"data": 16, "model": 16}),
    (["--mesh-shape", "2,4", "--devices", "8"], {"data": 2, "model": 4}),
])
def test_qwen2_every_shape_is_ok(tmp_path, capsys, argv, mesh_shape):
    rc = dryrun.main(["--arch", "qwen2-7b", "--mesh", "single", "--out", str(tmp_path)]
                     + argv)
    assert rc == 0
    recs = _records(tmp_path)
    assert sorted(recs) == sorted(f"qwen2-7b__{s}" for s in SHAPES)
    for rec in recs.values():
        assert rec["status"] == "ok" and KEYS <= set(rec)
        assert rec["mesh_shape"] == mesh_shape and rec["devices"] == 16 * 16 // (
            256 // (mesh_shape["data"] * mesh_shape["model"]))
        assert rec["memory"]["peak_bytes_est"] > 0 and rec["cost"]["flops"] > 0
        assert 0 < rec["roofline"]["roofline_fraction"] <= 1.5
        assert rec["fits_hbm"] == (rec["memory"]["peak_bytes_est"] <= 80e9)
    train = recs["qwen2-7b__train_4k"]
    assert train["plan"]["fsdp"] and train["plan"]["tp"] == 1
    assert train["collective_detail"]["all-gather"] > 0          # the FSDP gathers
    steps = max(1, train["plan"]["microbatch"])                 # 16 on the 2 x 4 mesh
    assert train["cost"]["kernel_detail"]["flash_attention_backward"]["launches"] == 28 * steps
    assert recs["qwen2-7b__decode_32k"]["cost"]["kernel_detail"]["decode_attention"][
        "launches"] == 28
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("  ok trace=") for ln in lines) == 3
    if not argv:
        _check_fsdp_traffic(train)


def _check_fsdp_traffic(rec):
    """qwen2-7b train_4k on 256 ranks, pure FSDP under remat: each cut leaf
    (in its dtype: bf16 weights, float32 norm scales) is reduce-scattered
    once a step; a layer's leaves are gathered twice (the forward and
    remat's recomputation), the embedding's and the head's once; each at
    the ring's 255/256 of the whole leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import CausalLM, jax_leaf
    from repro_torch.sharding import partitioning as pt
    cfg = get_config("qwen2-7b")
    mesh = make_mesh((16, 16), ("data", "model"), ["meta"] * 256)
    model = CausalLM(cfg, device="meta")
    shapes = pt.param_shape_tree(model)
    size = {jax_leaf(n, cfg)[0].replace(".", "/"): p.element_size()
            for n, p in model.named_parameters()}
    specs = pt.param_specs(shapes, cfg, mesh, fsdp=True, tp=1)
    cut = {k: size[k] * int(torch.Size(v).numel()) for k, v in shapes.items()
           if pt.data_dim(specs[k]) is not None}
    layers = sum(n for k, n in cut.items() if k.startswith("repeats/"))
    ring = 255 / 256
    detail = rec["collective_detail"]
    assert detail["reduce-scatter"] == pytest.approx(ring * sum(cut.values()), rel=1e-12)
    assert detail["all-gather"] == pytest.approx(ring * (sum(cut.values()) + layers),
                                                 rel=1e-12)


def test_a_failing_cell_is_an_error_record_and_rc_1(tmp_path, capsys, monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("made to fail")

    monkeypatch.setattr(dryrun, "trace_cell", fail)
    rc = dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k", "--mesh", "single",
                      "--mesh-shape", "2,2", "--devices", "4", "--out", str(tmp_path)])
    assert rc == 1
    rec = _records(tmp_path)["qwen2-7b__decode_32k"]
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: made to fail"
    assert "made to fail" in rec["traceback"]
    assert "  ERROR RuntimeError: made to fail" in capsys.readouterr().out


def test_the_module_parses_its_arguments_in_main_and_runs_as_a_command(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "recurrentgemma-2b",
         "--shape", "long_500k", "--mesh", "multi", "--mesh-shape", "2,2,2", "--devices", "8",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = _records(tmp_path)["recurrentgemma-2b__long_500k"]
    assert rec["mesh"] == "multi" and rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 2}
    assert "[cell] multi recurrentgemma-2b long_500k" in out.stdout


def test_abstract_meshes_stand_for_a_rank_of_a_world():
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), ["meta"] * 512)
    assert mesh.abstract and mesh.size == 512
    assert mesh.coords() == {"pod": 0, "data": 0, "model": 0}
    assert mesh.coords(300) == {"pod": 1, "data": 2, "model": 12}
    assert mesh.group("model") == AbstractGroup(16, 0)
    assert mesh.group(("data", "model")) == AbstractGroup(256, 0)
    assert mesh.group(("pod", "data", "model")) == AbstractGroup(512, 0)
    with pytest.raises(RuntimeError):
        make_mesh((16, 16), ("data", "model"), ["meta"] * 8)
