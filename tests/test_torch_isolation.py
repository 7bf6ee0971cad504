"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and none of the port's examples (``examples/torch_*.py``)
imports JAX or anything of the JAX package ``repro``, the port and its
examples run with both blocked from import, and the vectorized engine
and the serving path never land on the CPU unless the caller asks for
it."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE_FILES = sorted((ROOT / "examples").glob("torch_*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + EXAMPLE_FILES
BLOCKED = ("jax", "jaxlib", "repro")


def _imported(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES
             if "src" in p.parts}
    for mod in ("core/engine_torch.py", "sim/vectorized.py",
                "kernels/minskew.py", "kernels/hub_route.py",
                "kernels/ref.py", "kernels/ops.py", "kernels/_build.py",
                "kernels/flash_attention.py", "kernels/decode_attention.py",
                "kernels/rglru_scan.py", "kernels/mlstm_kernel.py",
                "models/transformer.py", "models/rglru.py",
                "models/xlstm.py", "models/moe.py", "models/encdec.py",
                "serve/loop.py", "sim/live.py",
                "sim/control.py", "sim/campaign.py", "sim/registry.py",
                "dist/coordinator.py", "dist/worker.py", "dist/frames.py",
                "optim/adamw.py", "optim/schedule.py", "optim/compress.py",
                "train/step.py", "data/pipeline.py",
                "checkpoint/manager.py", "runtime/trainer.py",
                "parallel/ctx.py", "parallel/sharding.py", "launch/mesh.py",
                "live/__main__.py",
                "core/des.py", "core/workloads.py", "launch/shapes.py",
                "launch/dryrun.py", "launch/costcount.py", "launch/count.py",
                "kernels/work.py"):
        assert f"repro_torch/{mod}" in names, mod
    for src in ("minskew.cu", "hub_route.cu", "flash_attention.cu",
                "decode_attention.cu", "rglru_scan.cu", "mlstm_kernel.cu",
                "flash_attention_bwd.cu", "flash_attention_bwd_sm90.cu",
                "flash_attention_bwd_tf32x3.cu", "flash_attention_tf32x3.cu",
                "rglru_scan_bwd.cu", "mlstm_kernel_bwd.cu",
                "mlstm_kernel_bwd_sm90.cu", "mlstm_kernel_bwd_tf32x3.cu",
                "mlstm_kernel_sm90.cu", "mlstm_kernel_tf32x3.cu"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
                / src).is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    bad = [name for name in _imported(path)
           if name.split(".")[0] in BLOCKED]
    assert not bad, f"{path.name} imports {bad}"


def test_port_runs_with_jax_and_repro_blocked():
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        from repro_torch.sim import RackRing, Simulation, Topology
        wl = RackRing(n_racks=2, hosts_per_rack=2, n_iters=4,
                      cross_every=2)
        rep = Simulation(Topology.racks(2, 2), wl).run(
            engine="vectorized", device="cpu", verify=True)
        assert rep.status == "ok" and rep.tier == "exact", rep.status
        wl = RackRing(n_racks=2, hosts_per_rack=2, n_iters=4,
                      cross_every=2)
        dist = Simulation(Topology.racks(2, 2), wl).run(
            engine="dist", n_workers=2, worker_timeout=60.0)
        assert dist.vtime_ns == rep.vtime_ns, dist.vtime_ns
        from repro_torch.sim import Campaign, registry
        ent = registry.entry("rack_ring@v1")
        camp = Campaign(ent.make, ent.grid(), seed=0,
                        device="cpu").run(minimize=False)
        assert camp.fast_path == "mixed", camp.fast_path
        assert registry.check(["rack_ring@v1", "serve_flip_min@v1"]) == []
        import torch
        from repro_torch import configs
        from repro_torch.models import registry
        from repro_torch.serve.loop import BatchServer
        for arch in ("qwen3_4b", "recurrentgemma_9b", "xlstm_1_3b"):
            cfg = configs.get_smoke(arch)
            params = registry.init(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
            out = BatchServer(cfg, params, max_new_tokens=3,
                              device="cpu").generate([[1, 2, 3, 4] * 3])
            assert out["tokens"].shape == (1, 3), out["tokens"].shape
        import dataclasses
        import tempfile
        from repro_torch.runtime import Trainer, TrainerConfig
        cfg = dataclasses.replace(configs.get_smoke("qwen3_4b"), remat=True)
        tcfg = TrainerConfig(n_steps=2, seq_len=16, global_batch=2,
                             checkpoint_every=1, checkpoint_async=False,
                             checkpoint_dir=tempfile.mkdtemp())
        out = Trainer(cfg, tcfg, log_fn=lambda s: None, device="cpu").run()
        assert out["final_step"] == 2, out
        from repro_torch.core import workloads
        from repro_torch.launch import shapes
        assert workloads.arith_des(iters=2).mode == "des"
        assert shapes.frontend_tokens(configs.get("pixtral_12b"), 64) == 32
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("ok", rep.vtime_ns)
        """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


def test_examples_run_with_jax_and_repro_blocked():
    """Each of the four examples imports with ``jax`` and ``repro``
    blocked; quickstart's model and serving parts and serve_batch run a
    few tokens on the CPU."""
    assert [p.name for p in EXAMPLE_FILES] == [
        "torch_cluster_sim.py", "torch_quickstart.py",
        "torch_serve_batch.py", "torch_train_100m.py"]
    code = textwrap.dedent(f"""
        import importlib.util
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError(f"blocked: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        mods = {{}}
        for path in {[str(p) for p in EXAMPLE_FILES]!r}:
            name = path.rsplit("/", 1)[1][:-3]
            spec = importlib.util.spec_from_file_location(name, path)
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
        q = mods["torch_quickstart"]
        logits, loss = q.part1_model(device="cpu")
        assert tuple(logits.shape) == (2, 32, 256), logits.shape
        out = q.part2_serving(device="cpu")
        assert out["tokens"].shape == (2, 8), out["tokens"].shape
        out = mods["torch_serve_batch"].run(batch=2, prompt_len=8,
                                            new_tokens=3, device="cpu")
        assert out["tokens"].shape[0] == 2, out["tokens"].shape
        assert callable(mods["torch_train_100m"].main)
        assert callable(mods["torch_cluster_sim"].run_autoscale)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("ok")
        """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "ok"


def test_no_device_without_cuda_raises(monkeypatch):
    """With no device named and no CUDA, the engine refuses instead of
    quietly running on the CPU."""
    from repro_torch.sim import RackRing, Scenario, Simulation, Topology
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def make():
        return Simulation(Topology.single_host(),
                          RackRing(n_racks=1, hosts_per_rack=1, n_iters=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make().run(engine="vectorized")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make().sweep([Scenario("a")])
    # the pure-Python engines take no device
    assert make().run(engine="single").status == "ok"


def test_serving_path_lands_on_cuda_unless_asked(monkeypatch):
    """``registry.init`` and ``BatchServer`` with no device named and no
    CUDA refuse; with ``device="cpu"`` they run on the CPU."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve.loop import BatchServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("recurrentgemma_9b", "xlstm_1_3b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.init(configs.get_smoke(arch), torch.Generator())
    cfg = configs.get_smoke("qwen3_4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init(cfg, torch.Generator())
    params = registry.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchServer(cfg, params)
    assert BatchServer(cfg, params, device="cpu").device.type == "cpu"
