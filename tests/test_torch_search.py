"""The port's copy of the search half (``repro_torch.core``, ``.calibration``,
``.gbt``, ``.hw``, ``.fleet``, ``.serve.search_service``/``.store``) against
the JAX package's originals.

Parity: every spec is built from one JSON text in both packages and searched
under the analytic eta model and under a small GBT eta model each package
trains from one seed; the reports' ``normalized_json()`` and the specs'
``cache_key()`` must agree byte for byte. Step traces cross the wire both
ways, and a calibration loop fed the same traces acks the same in both.

Drift: each copied module must parse to the same AST as its original once
docstrings are dropped and the package name is mapped, so an edit to either
copy fails here instead of diverging quietly.
"""
import ast
import dataclasses
import pathlib
import re

import pytest

pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()

import repro.calibration as jcal  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.calibration as tcal  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs import get_arch, get_reduced  # noqa: E402
from repro.serve.search_service import SearchService as JService  # noqa: E402
from repro_torch.serve.search_service import SearchService as TService  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

QWEN_REDUCED = get_reduced("qwen3-8b")
QWEN_8L = dataclasses.replace(get_arch("qwen3-8b"), num_layers=8)
SMALL_SPACE = {
    "tensor_parallel": [1, 2, 4],
    "pipeline_parallel": [1, 2],
    "micro_batch_size": [1, 2],
    "use_distributed_optimizer": [False, True],
    "recompute_granularity": ["none", "full"],
}


def _spec_json(name: str) -> str:
    J = jcore
    specs = {
        "h100x1-reduced": J.SearchSpec(QWEN_REDUCED, J.FixedPool("H100", 1),
                                       J.Workload(16, 64)),
        "h100x1-8layers": J.SearchSpec(QWEN_8L, J.FixedPool("H100", 1),
                                       J.Workload(4, 1024)),
        "h100x8": J.SearchSpec(QWEN_8L, J.FixedPool("H100", 8), J.Workload(32, 1024),
                               space=SMALL_SPACE),
        "hetero": J.SearchSpec(QWEN_8L, J.HeteroCaps(8, (("A800", 4), ("H100", 4))),
                               J.Workload(32, 1024)),
        "sweep-money": J.SearchSpec(QWEN_8L, J.DeviceSweep(("A800", "H100"), 8),
                                    J.Workload(32, 1024),
                                    objective=J.ObjectiveSpec.money(),
                                    space=SMALL_SPACE),
        "inference": J.SearchSpec(
            QWEN_8L, J.FixedPool("H100", 2),
            J.Workload(8, 1024, inference=J.InferenceShape(
                prefill_len=256, decode_len=64, batch_mix=((1, 1.0), (8, 3.0)),
                slo_per_token=0.5)),
            objective=J.ObjectiveSpec.latency(), space=SMALL_SPACE),
    }
    return specs[name].to_json()


SPECS = ("h100x1-reduced", "h100x1-8layers", "h100x8", "hetero", "sweep-money",
         "inference")


@pytest.fixture(scope="module")
def etas():
    """(jax, port) pairs: the analytic prior, and a small GBT model each
    package trains from the same seed (the settings of the JAX package's
    calibration tests)."""
    j_gbt, _ = jcal.train_eta_model(n_samples=600, n_estimators=40, seed=0)
    t_gbt, _ = tcal.train_eta_model(n_samples=600, n_estimators=40, seed=0)
    return {"analytic": (jcal.AnalyticEtaModel(), tcal.AnalyticEtaModel()),
            "gbt": (j_gbt, t_gbt)}


@pytest.fixture(autouse=True)
def _artifacts(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))


def test_eta_models_share_their_version(etas):
    for j, t in etas.values():
        assert j.version_string() == t.version_string()
    j, t = etas["gbt"]
    assert j.to_dict() == t.to_dict()


@pytest.mark.parametrize("eta", ["analytic", "gbt"])
@pytest.mark.parametrize("name", SPECS)
def test_search_report_matches_jax(name, eta, etas):
    text = _spec_json(name)
    j_spec, t_spec = jcore.SearchSpec.from_json(text), tcore.SearchSpec.from_json(text)
    assert t_spec.to_json() == text
    assert t_spec.cache_key() == j_spec.cache_key()
    j_eta, t_eta = etas[eta]
    # through the search service, as the train drivers search
    j_rep = JService(jcore.Astra(j_eta)).search(j_spec)
    t_rep = TService(tcore.Astra(t_eta)).search(t_spec)
    assert j_rep.best is not None
    assert t_rep.normalized_json() == j_rep.normalized_json()
    assert tcore.SearchReport.from_json(j_rep.to_json()).to_json() == j_rep.to_json()


def _trace(pkg_cal, pkg_core, *, seed, with_samples, source="replay"):
    truth = pkg_cal.GroundTruth(jitter_sigma=0.0, base_eff_scale=0.6, comm_eff_scale=0.8)
    comp, comm = ((), ())
    if with_samples:
        comp, comm = pkg_cal.replay_profile(truth, n_compute=60, n_comm=60, seed=seed)
    strategy = pkg_core.ParallelStrategy(device="H100", num_devices=8, tensor_parallel=2,
                                         micro_batch_size=2)
    return pkg_cal.simulate_step_trace(truth, QWEN_8L, strategy, global_batch=32,
                                       seq=1024, steps=3, source=source,
                                       compute_samples=comp, comm_samples=comm)


@pytest.mark.parametrize("with_samples", [False, True])
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_step_trace_crosses_the_wire(direction, with_samples):
    j = _trace(jcal, jcore, seed=3, with_samples=with_samples)
    t = _trace(tcal, tcore, seed=3, with_samples=with_samples)
    assert j.to_json() == t.to_json()
    src, dst = (t, jcal.StepTrace) if direction == "port-to-jax" else (j, tcal.StepTrace)
    back = dst.from_json(src.to_json())
    assert back.to_json() == src.to_json()
    assert back.measured_step_time == src.measured_step_time
    assert back.pool_key == src.pool_key and back.strategy_key == src.strategy_key


@pytest.mark.parametrize("eta", ["analytic", "gbt"])
def test_calibration_loop_acks_match_jax(eta, etas):
    """Eight drifted traces with op samples: the GBT loop refits on the
    last one, so the refit's new version is compared too."""
    j_eta, t_eta = etas[eta]
    kw = dict(min_traces=8, min_refit_samples=64, refit_estimators=20)
    j_loop, t_loop = jcal.CalibrationLoop(j_eta, **kw), tcal.CalibrationLoop(t_eta, **kw)
    refits = 0
    for seed in range(8):
        text = _trace(jcal, jcore, seed=seed, with_samples=True).to_json()
        j_ack = j_loop.ingest(jcal.StepTrace.from_json(text))
        t_ack = t_loop.ingest(tcal.StepTrace.from_json(text))
        assert t_ack == j_ack
        refits += j_ack["refit"]
    assert refits == (eta == "gbt")
    assert t_loop.version == j_loop.version


# ---------------------------------------------------------------------------
# drift: the copies stay copies
# ---------------------------------------------------------------------------

COPIED = (
    "hw/__init__", "hw/catalog", "hw/topology",
    "gbt/__init__", "gbt/tree", "gbt/boosting",
    "core/__init__", "core/arch", "core/params", "core/wire", "core/opspec",
    "core/memory", "core/costmodel", "core/simulate", "core/batch", "core/rules",
    "core/search", "core/funnel", "core/pareto", "core/hetero", "core/spec",
    "core/planner", "core/objectives", "core/http_client", "core/backend",
    "core/elastic", "core/api",
    "calibration/__init__", "calibration/truth", "calibration/traces",
    "calibration/fit", "calibration/registry", "calibration/loop",
    "fleet/__init__", "fleet/spec", "fleet/grid", "fleet/assign",
    "serve/__init__", "serve/search_service", "serve/store",
    "configs/qwen3_32b", "configs/command_r_35b",
)


def _dump_without_docstrings(path: pathlib.Path) -> str:
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_has_not_drifted(module):
    original = _dump_without_docstrings(JAX_PKG / f"{module}.py")
    copy = _dump_without_docstrings(PORT_PKG / f"{module}.py")
    assert copy == re.sub(r"\brepro\.", "repro_torch.", original)
