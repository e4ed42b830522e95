"""Rules of the port package: no JAX, nothing of ``repro``, card by default."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import DQF, DQFConfig
from tests.test_torch_cuda import (SCAN_KERNELS, same_bits, scan_cases,
                                   scan_kernel)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def test_dqf_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert DQF(DQFConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DQF(DQFConfig())
    assert DQF(DQFConfig(), device="cpu").device.type == "cpu"


def test_sharded_dqf_runs_on_the_card_by_default():
    from repro_torch.sharding import ShardedDQF

    if torch.cuda.is_available():
        assert ShardedDQF(DQFConfig(), 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedDQF(DQFConfig(), 2)
    assert ShardedDQF(DQFConfig(), 2, device="cpu").device.type == "cpu"


def test_sharded_engine_runs_on_the_card_by_default():
    """The engine takes no device: it runs where its index is, which is
    the card unless the index was built with ``device="cpu"``."""
    import inspect

    import numpy as np

    from repro_torch.sharding import ShardedDQF, ShardedEngine

    assert "device" not in inspect.signature(ShardedEngine).parameters
    x = np.random.default_rng(0).standard_normal((160, 8)).astype(np.float32)
    cfg = DQFConfig(dim=8, knn_k=8, out_degree=8, k=5, hot_pool=16,
                    full_pool=32, max_hops=50)
    cuda = torch.cuda.is_available()
    sd = ShardedDQF(cfg, 2, device=None if cuda else "cpu").build(x)
    sd.warm(x[:16])
    for paged in (False, True):
        eng = ShardedEngine(sd, wave_size=4, tick_hops=4, paged=paged)
        assert eng.device == sd.device
        assert eng.device.type == ("cuda" if cuda else "cpu")
        eng.submit(x[:6])
        assert eng.run_until_drained()["results"][5]["ids"].shape == (5,)
        state = eng._state.seen_pages if paged else eng._state.seen
        assert state.device == sd.device


def test_decoder_lm_runs_on_the_card_by_default():
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM

    cfg = get_config("qwen3-0.6b").reduced(num_layers=2)
    if torch.cuda.is_available():
        assert DecoderLM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecoderLM(cfg)
    model = DecoderLM(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_train_launcher_runs_on_the_card_by_default():
    """``--device`` defaults to the card: with none present the launcher
    and the example refuse, naming ``--device cpu``'s way out, and never
    train on the CPU unasked."""
    from repro_torch.examples import train_lm
    from repro_torch.launch import train

    argv = ["--reduced", "--steps", "1", "--batch", "2", "--seq", "8"]
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--steps", "1"])


def test_train_state_follows_its_model_device():
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_arrays
    from repro_torch.models import DecoderLM
    from repro_torch.training import TrainConfig, train_state_init

    cfg = get_config("qwen3-0.6b").reduced(num_layers=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_state_from_arrays({}, cfg)
    state = train_state_init(DecoderLM(cfg, device="cpu"), TrainConfig())
    assert state.opt.step.device.type == "cpu"
    assert {t.device.type for t in state.opt.m.values()} == {"cpu"}


def test_segment_index_runs_on_the_card_by_default():
    import numpy as np

    from repro_torch.core.ssg import SSGParams
    from repro_torch.serving.sharded import (build_sharded_index,
                                             sharded_search)

    x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    params = SSGParams(knn_k=6, out_degree=6)
    cfg = DQFConfig(k=5, full_pool=16, max_hops=20)
    if torch.cuda.is_available():
        idx = build_sharded_index(x, 2, params)
        sharded_search(idx, x[:4], cfg=cfg)
        assert list(idx._tables) == ["cuda"]
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_sharded_index(x, 2, params)
        idx = build_sharded_index(x, 2, params, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sharded_search(idx, x[:4], cfg=cfg)
    idx = build_sharded_index(x, 2, params, device="cpu")
    ids, _ = sharded_search(idx, x[:4], cfg=cfg, device="cpu")
    assert list(idx._tables) == ["cpu"] and ids.shape == (4, 5)


def test_retrieval_service_runs_on_the_card_by_default():
    import numpy as np

    from repro_torch.serving.retrieval import RetrievalService

    x = np.random.default_rng(0).standard_normal((160, 8)).astype(np.float32)
    cfg = DQFConfig(knn_k=8, out_degree=8, k=5, hot_pool=16, full_pool=32,
                    max_hops=50)
    payload = np.arange(160)
    if torch.cuda.is_available():
        assert RetrievalService.build(x, payload, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RetrievalService.build(x, payload, cfg)
    svc = RetrievalService.build(x, payload, cfg, device="cpu")
    tok, dists, ids = svc.lookup(torch.as_tensor(x[:4]))
    assert svc.device.type == "cpu" and svc.payload.device.type == "cpu"
    assert {t.device.type for t in (tok, dists, ids)} == {"cpu"}


@pytest.mark.parametrize("mode", ["sq8", "pq"])
def test_quantized_dqf_builds_and_searches_on_cpu(mode):
    from repro_torch.core import QuantConfig, ZipfWorkload
    from tests.conftest import make_clustered

    x = make_clustered(n=400, d=16, clusters=8)
    cfg = DQFConfig(knn_k=8, out_degree=8, index_ratio=0.05, k=5,
                    hot_pool=8, full_pool=16, max_hops=40, fused=True,
                    fused_hops=4, quant=QuantConfig(mode=mode, pq_m=4,
                                                    pq_iters=3))
    dqf = DQF(cfg, device="cpu").build(x)
    assert dqf.quant.mode == mode and dqf.timings.quant_train > 0
    assert dqf._quant_table().n == 400
    wl = ZipfWorkload(x, seed=2)
    dqf.warm(wl.sample(300))
    dqf.fit_tree(wl.sample(64))
    res = dqf.search(wl.sample(16))
    assert res.ids.shape == (16, 5) and bool(torch.isfinite(res.dists).all())
    assert int(res.ids.min()) >= 0 and int(res.ids.max()) < 400


def test_bogus_quant_mode_raises():
    from repro_torch.core import QuantConfig
    from repro_torch.quant import build_quantizer

    with pytest.raises(ValueError, match="none|sq8|pq"):
        QuantConfig(mode="bogus")
    with pytest.raises(ValueError, match="unknown quant mode"):
        build_quantizer(torch.zeros(4, 2).numpy(),
                        type("Q", (), {"mode": "bogus"})())


def test_port_imports_no_jax_and_nothing_of_repro():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.convert,"
            " repro_torch.kernels.ops, repro_torch.kernels.fused_hop,"
            " repro_torch.kernels.fused_topk_l2, repro_torch.kernels.distance,"
            " repro_torch.kernels.sq_distance, repro_torch.kernels.pq_adc,"
            " repro_torch.kernels.topk_merge,"
            " repro_torch.kernels.gather_distance, repro_torch.quant,"
            " repro_torch.obs, repro_torch.obs.bundle, repro_torch.store,"
            " repro_torch.tenancy, repro_torch.tiering, repro_torch.chaos,"
            " repro_torch.sharding, repro_torch.sharding.engine,"
            " repro_torch.sharding.health, repro_torch.serving.sharded,"
            " repro_torch.serving.engine,"
            " repro_torch.serving.paged_engine,"
            " repro_torch.serving.retrieval, repro_torch.configs,"
            " repro_torch.models, repro_torch.models.lm,"
            " repro_torch.models.moe, repro_torch.models.attention,"
            " repro_torch.models.ssm, repro_torch.models.xlstm,"
            " repro_torch.core.complexity, repro_torch.launch.serve,"
            " repro_torch.examples.streaming_updates,"
            " repro_torch.examples.quickstart,"
            " repro_torch.examples.drift_adaptation,"
            " repro_torch.examples.serve_knnlm, repro_torch.optim,"
            " repro_torch.optim.adamw, repro_torch.optim.schedule,"
            " repro_torch.training, repro_torch.training.train_step,"
            " repro_torch.data, repro_torch.data.pipeline,"
            " repro_torch.checkpoint, repro_torch.checkpoint.checkpointer,"
            " repro_torch.launch.train, repro_torch.examples.train_lm,"
            " repro_torch.launch.mesh, repro_torch.distributed,"
            " repro_torch.distributed.sharding,"
            " repro_torch.distributed.pipeline, repro_torch.distributed.mesh,"
            " repro_torch.distributed.tensor_parallel,"
            " repro_torch.sharding.merge, repro_torch.sharding.sharded,"
            " repro_torch.models.common, repro_torch.models.mlp;"
            "from repro_torch.configs import get_config, ARCH_IDS;"
            "[get_config(a) for a in ARCH_IDS];"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]; print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("wrong", ["cpu tensors", "wrong dtype"])
@pytest.mark.parametrize("name", SCAN_KERNELS)
def test_scan_wrappers_refuse_before_loading(monkeypatch, name, wrong):
    """A ``*_cuda`` wrapper given CPU tensors, or a wrong dtype, raises
    before it loads a library (no nvcc, no card needed to see it)."""
    from repro_torch.kernels import _build

    def no_load(source):
        raise AssertionError(f"{name} loaded {source} before its checks")

    monkeypatch.setattr(_build, "load", no_load)
    cuda_fn, _ = scan_kernel(name)
    _, args = next(scan_cases(name, "cpu"))
    if wrong == "wrong dtype":
        args = (args[0].double(), *args[1:])
    with pytest.raises(TypeError if wrong == "wrong dtype" else ValueError):
        cuda_fn(*args)
    assert cuda_fn.launches == 0


@pytest.mark.parametrize("name", SCAN_KERNELS)
def test_scan_ops_on_cpu_reach_the_plain_version(monkeypatch, name):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    plain = getattr(ref, name)
    calls = []
    monkeypatch.setattr(ref, name,
                        lambda *a: calls.append(1) or plain(*a))
    _, args = next(scan_cases(name, "cpu"))
    got = getattr(ops, name)(*args)
    assert calls == [1]
    assert same_bits(got, plain(*args))


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_jax_or_repro(path):
    bad = [line for line in path.read_text().splitlines()
           if IMPORT.match(line)]
    assert bad == []
