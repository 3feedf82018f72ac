"""Import hygiene and device rules of the torch port.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of ``repro`` (an AST scan of every import).
* Importing the port builds nothing and loads no CUDA library.
* Entry points run on the CUDA device by default and raise without one
  (the filters, ``generate``, ``smc_decode``, the session server, the
  serve and train launchers); ``forward_train`` runs every registered
  arch's smoke model (every layer kind, MoE FFNs with their aux values,
  the codebook head); what still raises is ``launch.train --devices N``
  for what the grid cannot run yet (ROADMAP A13 part b: the M, X, R and
  D kinds over a ``model`` axis, key/value heads the axis does not
  divide) and the flash-attention kernel on inputs that require grad,
  before it plans anything; the serving slice's modules exist and
  import neither ``jax`` nor the reference; ARNA, butterfly,
  ``domain=``, a bank over a mesh and ``bank_axis`` build and run, and
  an unknown ``bank_axis`` raises ``ValueError``.
* The chain resamplers and attention run on the CPU through their plain
  versions, and their CUDA wrappers refuse a CPU tensor instead of
  falling back.
* The config converters carry the reference's fields across, and refuse
  a forced ``fused_backend``, which the port does not honor.
* The process-group slice (ROADMAP A8b): the scan covers
  ``repro_torch.launch.mesh``, ``.track`` and ``.grid``, the runtime and
  the session server; importing the launchers starts no process group,
  no process and no CUDA context; neither a ``ProcessMesh`` nor a
  ``ProcessGrid`` is built without an initialized group.
* The training slice's modules (ROADMAP A12 training, parts a and b)
  are in the scan and import neither ``jax`` nor the reference.
* The grid slice's modules (ROADMAP A13 part a: ``launch.sharding``,
  ``launch.specs``, ``launch.lm_grid``) are in the scan, import neither,
  and importing them starts no process group and touches no CUDA.
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
from repro_torch.core.runtime import (EmulatedMesh, ProcessGrid, ProcessMesh,
                                     make_mesh)
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
PROCESS_MODULES = ("repro_torch.launch.mesh", "repro_torch.launch.track",
                   "repro_torch.launch.grid", "repro_torch.core.runtime",
                   "repro_torch.serve.sessions")
# the training slice's modules (ROADMAP A12 training part a)
TRAINING_MODULES = ("repro_torch.optim.adamw", "repro_torch.data.tokens",
                    "repro_torch.train.step", "repro_torch.launch.train",
                    "repro_torch.models.lm.model", "repro_torch.convert")
# the grid slice's modules (ROADMAP A13 part a)
GRID_MODULES = ("repro_torch.launch.sharding", "repro_torch.launch.specs",
                "repro_torch.launch.lm_grid", "repro_torch.models.lm.moe")


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


def _smoke_img(cfg, b=1):
    """Zero image embeddings for a cross-attending smoke arch, else None."""
    if not cfg.cross_attn_every:
        return None
    return torch.zeros((b, cfg.n_image_tokens, cfg.d_image))


def _smoke_tokens(cfg, b=1, t=4):
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return torch.zeros((b, t) + books, dtype=torch.int64)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "moonshot-v1-16b-a3b"])
def test_unported_layer_kinds_raise(arch):
    """The archs with an M layer or a MoE FFN (refused until the latent
    attention and MoE slice, then in training until its part b; the test
    keeps its name) build from both ways of building a decoder, with
    their M/MoE leaves, and ``forward_train`` runs them, frozen or
    trainable: finite hidden states and the MoE aux values summed over
    the layers."""
    import jax
    from repro.configs import get_config as ref_config
    from repro.models.lm import model as ref_model
    from repro_torch.models.lm import model as lm
    ref_cfg = ref_config(arch, smoke=True)
    cfg = convert.arch_config(dataclasses.asdict(ref_cfg))
    params = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.key(0), ref_cfg))
    tokens = _smoke_tokens(cfg)
    for model in (lm.init_params(cfg, 0, device="cpu"),
                  convert.lm_params(params, cfg),
                  lm.init_train_params(cfg, 0, device="cpu")):
        assert [(b.kind, b.ffn) for b in model.blocks] == list(
            lm.make_plan(cfg).layers())
        assert all(hasattr(b, "moe") for b in model.blocks[1:])
        assert all(hasattr(b, "mla") == (arch == "deepseek-v2-236b")
                   for b in model.blocks)
        hidden, aux = lm.forward_train(model, tokens)
        assert hidden.shape == (1, 4, cfg.d_model)
        assert torch.isfinite(hidden).all()
        assert sorted(aux) == ["moe_aux_loss", "moe_drop_frac",
                               "moe_max_load"]
        assert all(torch.isfinite(v.float()).all() for v in aux.values())
        assert hidden.requires_grad == model.embed.requires_grad


def test_sliding_window_training_and_sessions_raise():
    """The window is ported (the L layer), so both attention entry points
    take it: with a one-key window every query sees only its own key, so
    the output is ``v`` (the window's agreement with the reference's
    mask is tests/test_torch_attention_window.py's).  ``forward_train``
    (refused until the training slices; the test keeps its name) runs
    every registered arch's smoke model, frozen or trainable, with
    finite hidden states (and MoE aux values where there are MoE
    layers), and with a one-key window the training attention returns
    ``v`` too.  What still raises: ``launch.train --devices N`` for what
    the grid cannot run yet (ROADMAP A13 part b: here the M kind over a
    ``model`` axis) and the flash kernel on inputs that require grad."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch import train
    from repro_torch.models.lm import decode_ssm, layers
    from repro_torch.models.lm import model as lm
    from repro_torch.serve.smc_decode import suspended_decode_session
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 3, 16), generator=g) for _ in range(3))
    assert torch.equal(layers.causal_attention(q, k, v, window=1), v)
    assert torch.equal(layers.decode_attention(q[:, :, :1], k, v, 1,
                                               window=1), v[:, :, 1:2])
    assert torch.equal(layers.chunked_causal_attention(
        q, k, v, window=1, chunk=3), v)
    archs = list_archs()
    assert {"deepseek-v2-236b", "moonshot-v1-16b-a3b", "llama-3.2-vision-11b",
            "recurrentgemma-2b", "mamba2-1.3b", "musicgen-medium",
            "stablelm-3b"} <= set(archs)
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        tokens = _smoke_tokens(cfg)
        for model in (_smoke_lm(arch), lm.init_train_params(cfg, 0,
                                                            device="cpu")):
            hidden, aux = lm.forward_train(model, tokens, _smoke_img(cfg))
            assert hidden.shape == (1, 4, cfg.d_model), arch
            assert torch.isfinite(hidden).all(), arch
            assert hidden.requires_grad == model.embed.requires_grad
            moe = any(f == "moe" for _, f in lm.make_plan(cfg).layers())
            assert bool(aux) == moe, arch
            assert all(torch.isfinite(v.float()).all() for v in aux.values())
    assert not hasattr(lm, "check_trainable")
    with pytest.raises(SystemExit, match="ROADMAP A13 part b"):
        train.main(["--smoke", "--arch", "deepseek-v2-236b", "--devices",
                    "4", "--device", "cpu"])
    qg = q.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_kernel(qg, k, v)
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


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_attention_kernel_refuses_grad_before_planning(which):
    """B6 has no backward: with grad enabled, an input that requires grad
    is refused (``RuntimeError``) before the device check, the plan, the
    build or the count; without grad, or on the CPU through
    ``ops.attention``'s plain version, the same tensors run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q, k, v = _qkv()
    t = {"q": q, "k": k, "v": v}
    t[which] = t[which].requires_grad_()
    checked = dict(fa._CHECKED)
    launches = fa.flash_attention_kernel.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_kernel(t["q"], t["k"], t["v"])
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_kernel(t["q"], t["k"], t["v"])
    assert fa._CHECKED == checked
    assert fa.flash_attention_kernel.launches == launches
    assert not build._LIBS
    out = ops.attention(t["q"], t["k"], t["v"])
    out.float().sum().backward()
    assert t[which].grad is not None


def test_train_launcher_defaults_to_cuda(monkeypatch):
    """The train launcher runs on the card unless told ``cpu``, and fails
    without one, with ``--devices N`` too; a grid it cannot run yet exits
    before any rank starts (ROADMAP A13 part b: granite-34b's one
    key/value head over a ``model`` axis of 2)."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(SystemExit, match="CUDA"):
        train.main(["--smoke", "--steps", "1", "--devices", "2"])
    with pytest.raises(SystemExit, match="ROADMAP A13 part b"):
        train.main(["--smoke", "--arch", "granite-34b", "--devices", "4",
                    "--device", "cpu"])


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_are_scanned(module):
    """The AST scan covers the training slice's modules, and they import
    neither ``jax`` nor the reference."""
    path = PORT.parent.joinpath(*module.split(".")).with_suffix(".py")
    assert path in _port_files()
    importlib.import_module(module)
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{module} imports {bad}"


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
    ("v_wider", ValueError, "v head dim 32"),
    ("unserved_pair", ValueError, "v head dim 64"),
])
def test_attention_kernel_refuses_what_it_does_not_take(case, error, match):
    """The flash-attention wrapper checks its arguments before it loads
    anything, and the device last: every refusal shows on CPU tensors.
    A v head dim other than q's is taken only for the pairs the kernels
    serve (latent attention's (192, 128)): not wider than q's, and not
    (128, 64)."""
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
    elif case == "v_wider":
        v = _qkv(d=32)[2]
    elif case == "unserved_pair":
        q, k, _ = _qkv(d=128)
        v = _qkv(d=64)[2]
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


@pytest.mark.parametrize("module", GRID_MODULES)
def test_grid_modules_are_scanned(module):
    """The AST scan covers the grid slice's modules, and they import
    neither ``jax`` nor the reference."""
    path = PORT.parent.joinpath(*module.split(".")).with_suffix(".py")
    assert path in _port_files()
    importlib.import_module(module)
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{module} imports {bad}"


def test_importing_the_grid_modules_starts_nothing():
    """A fresh interpreter that imports the sharding rules, the specs and
    the grid workers has no process group, no child process and no CUDA
    context, and no active grid."""
    code = ("import multiprocessing, torch, torch.distributed as d\n"
            "import repro_torch.launch.sharding as s\n"
            "import repro_torch.launch.specs, repro_torch.launch.lm_grid\n"
            "print(d.is_initialized(), torch.cuda.is_initialized(), "
            "len(multiprocessing.active_children()), s.active_mesh())")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0", "None"]


def test_importing_the_launchers_starts_nothing():
    """A fresh interpreter that imports the launchers has no process
    group, no child process and no CUDA context."""
    code = ("import multiprocessing, torch, torch.distributed as d\n"
            "import repro_torch.launch.mesh, repro_torch.launch.track\n"
            "import repro_torch.launch.grid\n"
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
    with pytest.raises(RuntimeError, match="initialized process group"):
        ProcessGrid("gloo", (1, 1), ("bank", "data"))
