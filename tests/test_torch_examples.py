"""The port's four examples (``examples/torch_*.py``) against the JAX
package's on the CPU.

quickstart: part 1's float32 logits and loss within 1e-4 x max(1, the
logits' largest |value|) of JAX's on parameters carried across by
``params_from_jax`` and the same tokens; part 2's greedy tokens,
``decode_steps`` and ``tokens_out`` equal to JAX's ``BatchServer``'s;
part 3's live RPC demo takes its vtime from the host clock, so only its
structure is held (every task done, 20 round trips), in both packages.
serve_batch: float32 tokens equal to JAX's, on carried parameters and
JAX's prompts, for every family whose JAX example runs as written.
train_100m: the two configs equal to JAX's field by field; three float32
steps of the quick preset through the port's ``Trainer`` and JAX's from
carried parameters, losses within the trainer tests' 1e-5 relative
(``tests/test_torch_train.py``); a run with a simulated host failure
restarts once.  cluster_sim: ``--smoke``'s printed report equal to the
JAX example's line for line once the ``wall=`` fields are taken out,
each example in a fresh process (task ids are process-global, ROADMAP
C5) with the dry-run ``RESULTS`` pointed at one temporary directory:
empty (the fallback constants), or holding one ``StepCost`` record.
Every example at its own sizes, bfloat16, runs through ``main``.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.models.common import softmax_cross_entropy as jsce
from repro.optim import adamw_init as jadamw_init
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro.serve.loop import BatchServer as JaxServer
from repro_torch import configs as tconfigs
from repro_torch.models.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tq():
    return _load("torch_quickstart")


@pytest.fixture(scope="module")
def ts():
    return _load("torch_serve_batch")


@pytest.fixture(scope="module")
def tt():
    return _load("torch_train_100m")


def _f32(arch: str):
    """The arch's JAX and port smoke configs in float32."""
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32),
            dataclasses.replace(tconfigs.get_smoke(arch),
                                dtype=torch.float32))


def _carried(jcfg, tcfg, seed: int = 0):
    jparams = jreg.init(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


# ------------------------------------------------------------- quickstart


@pytest.fixture(scope="module")
def qwen_pair():
    jcfg, tcfg = _f32("qwen3-4b")
    return (jcfg, tcfg) + _carried(jcfg, tcfg)


def test_quickstart_part1_matches_jax(tq, qwen_pair):
    jcfg, tcfg, jparams, tparams = qwen_pair
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 32),
                                         0, jcfg.vocab))
    jlogits = jreg.forward(jcfg, jparams, jnp.asarray(tokens))
    jloss = float(jsce(jlogits[:, :-1], jnp.asarray(tokens)[:, 1:]))
    (tlogits, tloss), text = _printed(tq.part1_model, cfg=tcfg,
                                      params=tparams, tokens=tokens,
                                      device="cpu")
    jlogits = np.asarray(jlogits)
    assert tlogits.shape == jlogits.shape == (2, 32, jcfg.vocab)
    scale = max(1.0, float(np.abs(jlogits).max()))
    assert float(np.abs(tlogits.numpy() - jlogits).max()) <= 1e-4 * scale
    assert abs(float(tloss) - jloss) <= 1e-4 * max(1.0, abs(jloss))
    assert f"logits (2, 32, {jcfg.vocab}), loss {jloss:.3f}" in text
    assert "full config: 36L d=2560 params=4.41B" in text


def test_quickstart_part2_tokens_match_jax(tq, qwen_pair):
    jcfg, tcfg, jparams, tparams = qwen_pair
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 16),
                                          0, jcfg.vocab))
    j = JaxServer(jcfg, jparams, max_new_tokens=8).generate(
        jnp.asarray(prompts))
    t, text = _printed(tq.part2_serving, cfg=tcfg, params=tparams,
                       prompts=prompts, device="cpu")
    np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
    assert t["tokens"].shape == (2, 8)
    assert t["stats"].decode_steps == j["stats"].decode_steps
    assert t["stats"].tokens_out == j["stats"].tokens_out
    assert "generated (2, 8) tokens" in text


def _rpc_structure(module, monkeypatch) -> dict:
    """Runs ``module.part3_livestack`` with its hub and vtasks recorded:
    every task done, round trips counted from the hub's messages."""
    hubs, tasks = [], []

    class Hub(module.Hub):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            hubs.append(self)

    class VTask(module.VTask):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tasks.append(self)

    monkeypatch.setattr(module, "Hub", Hub)
    monkeypatch.setattr(module, "VTask", VTask)
    out, text = _printed(module.part3_livestack)
    (hub,) = hubs
    return {"out": out, "text": text,
            "done": [t.state.value for t in tasks],
            "round_trips": hub.stats["messages"] // 2,
            "dispatches_line": re.search(r"\(\d+ dispatches, \d+ skew "
                                         r"stalls\)", text) is not None}


def test_quickstart_part3_structure_in_both_packages(tq, monkeypatch):
    j = _rpc_structure(_load("quickstart"), monkeypatch)
    t = _rpc_structure(tq, monkeypatch)
    for got in (j, t):
        assert got["done"] == ["done", "done"]
        assert got["round_trips"] == 20
        assert got["dispatches_line"], got["text"]
    assert t["out"]["status"] == "ok" and t["out"]["round_trips"] == 20


def test_quickstart_main_runs_on_the_cpu(tq):
    _, text = _printed(tq.main, ["--device", "cpu"])
    heads = [line for line in text.splitlines() if line.startswith("===")]
    assert heads == ["=== 1. model zoo ===", "=== 2. serving ===",
                     "=== 3. live simulation (the paper) ==="]
    assert "qwen3-4b-smoke: logits (2, 32, 256)" in text
    assert "generated (2, 8) tokens" in text


# ------------------------------------------------------------ serve_batch

#: every family's smoke arch whose JAX example runs as written
SERVE_ARCHS = ("qwen3_4b", "recurrentgemma_9b", "xlstm_1_3b", "olmoe_1b_7b",
               "pixtral_12b", "glm4_9b", "deepseek_coder_33b",
               "phi3_medium_14b", "moonshot_v1_16b_a3b")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_batch_tokens_match_jax(ts, arch):
    jcfg, tcfg = _f32(arch)
    jparams, tparams = _carried(jcfg, tcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 64),
                                            1, jcfg.vocab))
    j = JaxServer(jcfg, jparams, max_new_tokens=16, eos_id=0).generate(
        jnp.asarray(prompts))
    t, text = _printed(ts.run, arch, cfg=tcfg, params=tparams,
                       prompts=prompts, device="cpu")
    np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
    assert t["stats"].decode_steps == j["stats"].decode_steps
    assert t["stats"].tokens_out == j["stats"].tokens_out
    lines = text.splitlines()
    assert lines[0] == (f"arch={tcfg.name} batch=4 prompt=64 "
                        f"new={np.asarray(j['tokens']).shape[1]}")
    assert lines[2] == f"first row: {np.asarray(j['tokens'])[0][:12]}"


def test_serve_batch_encdec_needs_frames_in_both_packages(ts):
    """seamless_m4t_medium's example does not run as written: the
    encoder-decoder refuses to prefill without audio frames, in JAX and
    in the port alike."""
    jcfg = jconfigs.get_smoke("seamless_m4t_medium")
    jsrv = JaxServer(jcfg, jreg.init(jcfg, jax.random.PRNGKey(0)),
                     max_new_tokens=2, eos_id=0)
    with pytest.raises(AssertionError):
        jsrv.generate(jnp.ones((1, 8), jnp.int32))
    with pytest.raises(ValueError, match="frontend embeds"):
        _printed(ts.main, ["--arch", "seamless_m4t_medium", "--device",
                           "cpu", "--batch", "1", "--prompt-len", "8"])


def test_serve_batch_main_runs_on_the_cpu(ts):
    out, text = _printed(ts.main, ["--device", "cpu"])
    lines = text.splitlines()
    assert len(lines) == 3 and lines[0].startswith(
        "arch=qwen3-4b-smoke batch=4 prompt=64 new=")
    assert lines[1].startswith("prefill ") and "ms/tok" in lines[1]
    assert out["tokens"].shape[0] == 4 and out["tokens"].shape[1] <= 16


# ------------------------------------------------------------- train_100m


@pytest.fixture(scope="module")
def jt():
    return _load("train_100m")


@pytest.fixture
def one_thread():
    """One intra-op thread for the train runs: beside other test workers
    on the same cores, torch's default pool slowed a step of the quick
    preset from 0.1 s to 10 s; one thread takes 0.2 s whatever the load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", ("model_100m", "model_quick"))
def test_train_configs_match_jax(tt, jt, name):
    j = getattr(jt, name)()
    t = getattr(tt, name)()
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd.pop("dtype") == jnp.bfloat16
    assert td.pop("dtype") == torch.bfloat16
    assert jd == td
    assert j.n_params() == t.n_params()


def test_train_three_steps_match_jax(tt, jt, tmp_path, one_thread):
    jcfg = dataclasses.replace(jt.model_quick(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tt.model_quick(), dtype=torch.float32)
    jparams, tparams = _carried(jcfg, tcfg)
    tc = tt.trainer_config(False, 3, str(tmp_path / "t"))
    jtc = JTrainerConfig(**dict(dataclasses.asdict(tc),
                                checkpoint_dir=str(tmp_path / "j")))
    jtr = JTrainer(jcfg, jtc, log_fn=lambda _s: None)
    jtr.init_state = lambda: (jparams, jadamw_init(jparams))
    jout = jtr.run()
    tout, _ = _printed(tt.train, tcfg, tc, device="cpu", params=tparams)
    jl = [h["loss"] for h in jout["history"]]
    tl = [h["loss"] for h in tout["history"]]
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl, tl):
        assert abs(a - b) <= 1e-5 * abs(a), (jl, tl)


def test_train_main_restarts_once(tt, tmp_path, one_thread):
    """A host failure at step 27 restores the checkpoint of step 25 (one
    is written every 25 steps) and replays steps 25 and 26."""
    steps, fail_at = 30, 27
    out, text = _printed(tt.main, ["--device", "cpu", "--steps", str(steps),
                                   "--fail-at", str(fail_at),
                                   "--ckpt-dir", str(tmp_path)])
    assert out["restarts"] == 1 and out["final_step"] == steps
    assert [h["step"] for h in out["history"]] == \
        list(range(fail_at)) + list(range(25, steps))
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert "simulated failure" in text and "no checkpoint" not in text
    assert text.splitlines()[0] == (f"model qwen3-20m: "
                                    f"{tt.model_quick().n_params()/1e6:.1f}M "
                                    f"params, {steps} steps")
    assert text.splitlines()[-1].startswith(
        f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}, restarts=1, ")


# ------------------------------------------------------------ cluster_sim

WALL = re.compile(r" ?wall=[0-9.]+ ?m?s")


def _cluster_sim(example: str, package: str, results: pathlib.Path) -> list:
    code = textwrap.dedent(f"""
        import pathlib, runpy, sys
        import {package}.core.cluster as cluster
        cluster.RESULTS = pathlib.Path({str(results)!r})
        sys.argv = [{example!r}, "--smoke"]
        runpy.run_path({str(EXAMPLES / example)!r}, run_name="__main__")
        """)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return [WALL.sub("", line) for line in out.stdout.splitlines()]


def _step_cost_record(results: pathlib.Path) -> None:
    """One raw dry-run record of qwen3_4b x train_4k on the 2-pod mesh,
    as ``StepCost.from_dryrun`` reads it."""
    results.mkdir(parents=True)
    (results / "qwen3_4b__train_4k__2x16x16.json").write_text(json.dumps({
        "status": "ok", "flops_per_chip": 3.1e14, "bytes_per_chip": 2.2e12,
        "collectives": {"count": 12, "all-reduce": 4.0e10,
                        "all-gather": 1.5e9}}))


@pytest.mark.parametrize("record", (False, True),
                         ids=("fallback_constants", "one_record"))
def test_cluster_sim_smoke_matches_jax(tmp_path, record):
    results = tmp_path / "dryrun"
    if record:
        _step_cost_record(results)
    j = _cluster_sim("cluster_sim.py", "repro", results)
    t = _cluster_sim("torch_cluster_sim.py", "repro_torch", results)
    assert t == j
    want = ("dry-run artifact: compute=" if record
            else "fallback constants (run launch/dryrun first): compute=5.00")
    assert want in t[0]
    assert any("identical results" in line for line in t)
    assert t[-1].startswith("  700 requests, boots=")


# --------------------------------------------------- no card, no fallback


def test_model_examples_need_cuda_unless_asked(tq, ts, tt, monkeypatch,
                                               tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((tq.main, []), (ts.main, []),
                       (tt.main, ["--steps", "1", "--ckpt-dir",
                                  str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _printed(main, argv)
