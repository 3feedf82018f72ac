"""Import hygiene and device rules of the torch port.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of ``repro`` (an AST scan of every import).
* Importing the port builds nothing and loads no CUDA library.
* Entry points run on the CUDA device by default and raise without one
  (the filters, ``generate``, ``smc_decode``, the session server and
  the serve launcher); the options of later slices (the LM layer kinds
  L/M/X/R/D, MoE FFNs, multi-codebook heads, sliding windows, training)
  raise ``NotImplementedError``; the serving slice's modules exist and
  import neither ``jax`` nor the reference; ARNA, butterfly,
  ``domain=``, a bank over a mesh and ``bank_axis`` build and run, and
  an unknown ``bank_axis`` raises ``ValueError``.
* The chain resamplers and attention run on the CPU through their plain
  versions, and their CUDA wrappers refuse a CPU tensor instead of
  falling back.
* The config converters carry the reference's fields across, and refuse
  a forced ``fused_backend``, which the port does not honor.
* The process-group slice (ROADMAP A8b): the scan covers
  ``repro_torch.launch.mesh`` and ``.track``; importing them starts no
  process group, no process and no CUDA context; a ``ProcessMesh`` is
  not built without an initialized group.
"""
import ast
import dataclasses
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_draws import one_torch_thread  # noqa: F401

from repro.core import SIRConfig as RefSIR
from repro.models import tracking as jtracking
from repro_torch import convert
from repro_torch.core import FilterBank, ParallelParticleFilter, SIRConfig
from repro_torch.core.distributed import DRAConfig
from repro_torch.core.runtime import EmulatedMesh, ProcessMesh, make_mesh
from repro_torch.kernels import build
from repro_torch.kernels import resample as resample_kernels
from repro_torch.models.tracking import TrackingConfig, TrackingSSM

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# the serving slice's modules (ROADMAP A11)
SERVING_MODULES = ("repro_torch.checkpoint.store", "repro_torch.serve.metrics",
                   "repro_torch.serve.sessions", "repro_torch.serve.frontend",
                   "repro_torch.serve.fleet", "repro_torch.launch.registry",
                   "repro_torch.launch.serve", "repro_torch.serve.smc_decode",
                   "repro_torch.kernels.row_sum")
# the process-group slice's modules (ROADMAP A8b)
PROCESS_MODULES = ("repro_torch.launch.mesh", "repro_torch.launch.track")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_builds_nothing():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        importlib.import_module(".".join(rel.parts).removesuffix(".__init__"))
    assert not build._LIBS
    assert sorted(p.name for p in build.sources()) == [
        "comb_scan.cu", "flash_attention.cu", "flash_attention_sm90.cu",
        "patch_likelihood.cu", "resample.cu", "row_sum.cu", "sir_fused.cu"]
    assert len(build.source_hash()) == 16


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TrackingSSM(TrackingConfig(img_size=(16, 16)))
    with pytest.raises(RuntimeError, match="CUDA"):
        ParallelParticleFilter(model, SIRConfig(n_particles=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        FilterBank(model, SIRConfig(n_particles=8))
    pf = ParallelParticleFilter(model, SIRConfig(n_particles=8),
                                device="cpu")
    assert pf.device == torch.device("cpu")


def test_serving_entry_points_default_to_cuda(monkeypatch):
    """The session server and the serve launcher run on the card unless
    told ``cpu``, and fail without one."""
    from repro_torch.launch import serve
    from repro_torch.serve import ParticleSessionServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = serve.lg_demo_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        ParticleSessionServer(model, SIRConfig(n_particles=8), capacity=2)
    with pytest.raises(SystemExit, match="CUDA"):
        serve.main(["--mode", "sessions"])
    srv = ParticleSessionServer(model, SIRConfig(n_particles=8), capacity=2,
                                device="cpu")
    assert srv.device == torch.device("cpu")


def _bank_over_mesh(option):
    model = TrackingSSM(TrackingConfig(img_size=(16, 16)))
    sir = SIRConfig(n_particles=8)
    if option == "mesh":        # a bank over a mesh
        return FilterBank(model, sir, device="cpu", mesh=EmulatedMesh(2))
    return FilterBank(model, sir, device="cpu", bank_axis="bank",
                      mesh=make_mesh((2, 2), ("bank", "data")))


@pytest.mark.parametrize("option", ["mesh", "bank_axis"])
def test_bank_over_mesh_runs(option):
    """A bank over a mesh and ``bank_axis`` build and run on the CPU: a
    ``(B, P, C, ...)`` final ensemble and ``(B, K, ...)`` results."""
    bank = _bank_over_mesh(option)
    res = bank.run([0, 1], torch.randn(
        2, 2, 16, 16, generator=torch.Generator().manual_seed(0)))
    assert res.final.state.shape == (2, 2, 4, 5)
    assert res.estimates.shape == (2, 2, 5)
    assert bool(torch.isfinite(res.estimates).all())


def test_unknown_bank_axis_raises():
    with pytest.raises(ValueError, match="not in mesh axes"):
        FilterBank(TrackingSSM(TrackingConfig(img_size=(16, 16))),
                   SIRConfig(n_particles=8), device="cpu",
                   mesh=make_mesh((2, 2), ("bank", "data")),
                   bank_axis="members")


@pytest.mark.parametrize("kind", ["arna", "butterfly"])
def test_arna_and_butterfly_construct(kind):
    """Both DRAs of this slice build and run on the CPU: a filter on an
    emulated mesh takes them."""
    dra = DRAConfig(kind=kind)
    model = TrackingSSM(TrackingConfig(img_size=(16, 16)))
    pf = ParallelParticleFilter(model, SIRConfig(n_particles=16),
                                device="cpu", mesh=EmulatedMesh(2), dra=dra)
    res = pf.run(0, torch.randn(2, 16, 16,
                                generator=torch.Generator().manual_seed(0)))
    assert pf.dra.kind == kind
    assert bool(torch.isfinite(res.estimates).all())


def test_domain_constructs_and_runs():
    """``domain=`` builds on a mesh of as many shards as tiles and runs."""
    from repro_torch.models.tracking import make_domain_spec
    cfg = TrackingConfig(img_size=(16, 16))
    spec = make_domain_spec(cfg, 2)
    pf = ParallelParticleFilter(TrackingSSM(cfg), SIRConfig(n_particles=16),
                                device="cpu", mesh=EmulatedMesh(2),
                                domain=spec)
    res = pf.run(0, torch.randn(2, 16, 16,
                                generator=torch.Generator().manual_seed(0)))
    assert pf.domain is spec
    assert res.diag["mig_overflow"].shape == (2,)


@pytest.mark.parametrize("backend", ["composed", "fused"])
@pytest.mark.parametrize("scheme", ["metropolis", "rejection"])
def test_chain_resamplers_raise_instead_of_falling_back(backend, scheme):
    """The chain schemes run on the CPU through their plain versions;
    their CUDA wrapper refuses the CPU tensor instead of falling back."""
    model = TrackingSSM(TrackingConfig(img_size=(16, 16)))
    pf = ParallelParticleFilter(model, SIRConfig(
        n_particles=8, resampler=scheme, step_backend=backend,
        always_resample=True), device="cpu")
    res = pf.run(0, torch.randn(2, 16, 16,
                                generator=torch.Generator().manual_seed(0)))
    assert bool(res.resampled.all())
    assert bool(torch.isfinite(res.estimates).all())
    kernel = getattr(resample_kernels, f"{scheme}_ancestors_kernel")
    with pytest.raises(ValueError, match="CUDA"):
        kernel(res.final.log_weights[None],
               torch.zeros(1, 8, 32, dtype=torch.int32),
               torch.zeros(1, 8, 32))


def test_fused_falls_back_to_composed_for_comb_schemes():
    """A comb-only resampler under ``step_backend="fused"`` takes the
    composed step, as the reference's config fallback does."""
    model = TrackingSSM(TrackingConfig(img_size=(16, 16)))
    frames = torch.randn(3, 16, 16, generator=torch.Generator().manual_seed(0))
    runs = [ParallelParticleFilter(model, SIRConfig(
        n_particles=64, resampler="stratified", step_backend=b),
        device="cpu").run(5, frames) for b in ("fused", "composed")]
    assert torch.equal(runs[0].estimates, runs[1].estimates)


def test_converters_carry_reference_fields():
    jcfg = jtracking.TrackingConfig(img_size=(48, 40), sigma_like=1.5,
                                    likelihood_form="eq4")
    assert dataclasses.asdict(convert.tracking_config(
        dataclasses.asdict(jcfg))) == dataclasses.asdict(jcfg)
    jsir = RefSIR(n_particles=128, resampler="residual", ess_frac=0.3,
                  step_backend="fused")
    want = dataclasses.asdict(jsir)
    assert want.pop("fused_backend") is None
    assert dataclasses.asdict(convert.sir_config(
        dataclasses.asdict(jsir))) == want
    with pytest.raises(ValueError, match="fused_backend"):
        convert.sir_config(dataclasses.asdict(
            dataclasses.replace(jsir, fused_backend="jnp")))
    ens = convert.ensemble_from_numpy(np.ones((4, 5)), np.zeros(4),
                                      np.ones(4))
    assert ens.state.dtype == torch.float32
    assert ens.counts.dtype == torch.int32 and ens.capacity == 4


def _smoke_lm(arch="qwen3-32b"):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as lm
    return lm.init_params(get_config(arch, smoke=True), 0, device="cpu")


def test_lm_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.serve import SMCDecodeConfig, generate, smc_decode
    model = _smoke_lm()
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(model, prompt, steps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        smc_decode(model, prompt, SMCDecodeConfig(n_particles=2, steps=2))
    assert generate(model, prompt, steps=2, device="cpu").shape == (1, 2)


@pytest.mark.parametrize("arch", [
    "gemma3-27b", "deepseek-v2-236b", "llama-3.2-vision-11b",
    "recurrentgemma-2b", "mamba2-1.3b", "moonshot-v1-16b-a3b",
    "musicgen-medium"])
def test_unported_layer_kinds_raise(arch):
    """Every arch with an L/M/X/R/D layer, a MoE FFN or a multi-codebook
    head raises, naming the ROADMAP item, from both ways of building a
    decoder."""
    from repro.configs import get_config as ref_config
    from repro_torch.models.lm import model as lm
    cfg = convert.arch_config(dataclasses.asdict(ref_config(arch, smoke=True)))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        convert.lm_params({"embed": np.zeros((2, 2)), "blocks": {
            "l0_X_moe": {"pre_norm": np.zeros((1, 2))}},
            "final_norm": np.zeros(2)}, cfg)


def test_sliding_window_training_and_sessions_raise():
    from repro_torch.models.lm import decode_ssm, layers
    from repro_torch.serve.smc_decode import suspended_decode_session
    q = torch.zeros((1, 2, 3, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        layers.causal_attention(q, q, q, window=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        layers.decode_attention(q[:, :, :1], q, q, 2, window=2)
    from repro_torch.models.lm import model as lm
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        lm.forward_train(_smoke_lm(), torch.zeros((1, 4), dtype=torch.int64))
    # session-hosted decoding is ported (ROADMAP A11): its module and the
    # other serving modules exist and import neither jax nor the reference
    assert callable(suspended_decode_session)
    assert decode_ssm.LMDecodeSSM
    for mod in SERVING_MODULES:
        path = PORT.joinpath(*mod.split(".")[1:]).with_suffix(".py")
        assert path.is_file(), mod
        importlib.import_module(mod)
        bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
        assert not bad, f"{mod} imports {bad}"


def test_attention_kernel_refuses_cpu_tensors():
    """On the CPU ``ops.attention`` runs the plain version; the kernel
    wrapper refuses the same CPU tensors instead of falling back."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    q = torch.randn(1, 4, 3, 16, generator=torch.Generator().manual_seed(0))
    k = q[:, :2]
    assert ops.attention(q, k, k).shape == q.shape
    launches = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, k, k)
    assert flash_attention_kernel.launches == launches
    assert not build._LIBS


@pytest.mark.parametrize("shape", [
    ((1, 64, 1, 128), (1, 8, 40, 128)),        # a decode step: "split"
    ((1, 16, 80, 128), (1, 2, 80, 128)),       # a prefill: "wgmma"
    ((1, 4, 3, 16), (1, 2, 5, 16)),            # "mma"
])
def test_attention_kernel_refuses_cpu_tensors_before_planning(shape):
    """Whatever variant a shape would take, the wrapper refuses CPU
    tensors before it plans, allocates, builds or counts anything."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(2)
    q, k = (torch.randn(s, generator=g).to(torch.bfloat16) for s in shape)
    checked = dict(fa._CHECKED)
    variants = dict(fa.flash_attention_kernel.variants)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_kernel(q, k, k)
    assert fa._CHECKED == checked
    assert fa.flash_attention_kernel.variants == variants
    assert not build._LIBS


def _qkv(b=1, hq=4, hkv=2, lq=3, lk=5, d=16, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)
    return [torch.randn(s, generator=g).to(dtype) for s in
            ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "float32 or bfloat16"),
    ("mixed", TypeError, "q is"),
    ("rank", ValueError, r"\(B, H, L, D\)"),
    ("heads", ValueError, "do not group"),
    ("causal", ValueError, "Lq <= Lk"),
    ("head_dim", ValueError, "head dim"),
    ("misaligned", ValueError, "16-byte aligned"),
    ("strided_last", ValueError, "last dim"),
    ("cpu", ValueError, "CUDA"),
])
def test_attention_kernel_refuses_what_it_does_not_take(case, error, match):
    """The flash-attention wrapper checks its arguments before it loads
    anything, and the device last: every refusal shows on CPU tensors."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    q, k, v = _qkv()
    if case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed":
        k = k.float()
    elif case == "rank":
        q = q[0]
    elif case == "heads":
        q = torch.cat([q, q[:, :1]], 1)
    elif case == "causal":
        q, k, v = _qkv(lq=6, lk=5)
    elif case == "head_dim":
        q, k, v = _qkv(d=24)
    elif case == "misaligned":
        k = torch.zeros(1, 2, 5, 17, dtype=torch.bfloat16)[..., 1:]
    elif case == "strided_last":
        q = q.transpose(2, 3)
    with pytest.raises(error, match=match):
        flash_attention_kernel(q, k, v)
    assert not build._LIBS


@pytest.mark.parametrize("module", PROCESS_MODULES)
def test_process_modules_are_scanned(module):
    """The AST scan above covers the process-group slice's modules, and
    they import neither ``jax`` nor the reference."""
    path = PORT.parent.joinpath(*module.split(".")).with_suffix(".py")
    assert path in _port_files()
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{module} imports {bad}"


def test_importing_the_launchers_starts_nothing():
    """A fresh interpreter that imports the launchers has no process
    group, no child process and no CUDA context."""
    code = ("import multiprocessing, torch, torch.distributed as d\n"
            "import repro_torch.launch.mesh, repro_torch.launch.track\n"
            "print(d.is_initialized(), torch.cuda.is_initialized(), "
            "len(multiprocessing.active_children()))")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0"]


def test_process_mesh_needs_an_initialized_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        ProcessMesh("gloo")
