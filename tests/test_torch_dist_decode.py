"""The port's GPipe pipeline and flash decoding over real gloo worlds of 2
and 4 ranks, against the reference on faked devices.

The rank bodies are in ``tests/_torch_dist.py`` (spawned processes, one
``file://`` store each, no process group in the pytest process).  The
reference's ``pipeline_forward`` and ``_flash_decode`` run under
``shard_map`` on ``--xla_force_host_platform_device_count=4`` virtual
CPU devices in one subprocess (as ``tests/test_pipeline.py`` does); JAX's
default ``decode_step`` runs here on the one real device.

Contracts: the pipeline within 1e-5 of the stages applied in sequence
(the reference's) and within 1e-6 of the reference's pipeline at world 2;
one GQA layer's flash decode at world 2 and 4 within 1e-5 of max |o| of
the reference's, its caches (gathered from the ranks) bit for bit, an
indivisible window refused; the reduced Qwen3 decoding 5 steps through
flash decoding within 1e-5 of max |logits| of JAX's default decode (and
the reference test's 2e-2 against the port's own default decode).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import bubble_fraction
from tests import _torch_dist as td
from tests._torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
WINDOWS = (0, 5)
B, W, H, HKV, HD = 2, 8, 4, 2, 8
STEPS = list(range(5, 10))          # pos 8, 9 wrap the ring of 8
MAX_LEN = 64

REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from types import SimpleNamespace
    from repro.distributed.pipeline import pipeline_forward
    from repro.models.attention import KVCache, _flash_decode
    inp, out = sys.argv[1], sys.argv[2]
    z = np.load(inp)
    devs = np.asarray(jax.devices())
    res = {}
    mesh = Mesh(devs[:2].reshape(2, 1), ("pod", "model"))
    def stage(params, h):
        W, b = params
        return jnp.tanh(h @ W + b)
    res["pipe"] = np.asarray(jax.jit(lambda p, x: pipeline_forward(
        stage, p, x, mesh, axis="pod"))(
        (jnp.asarray(z["Ws"]), jnp.asarray(z["bs"])), jnp.asarray(z["x"])))
    cfg = SimpleNamespace(num_heads=int(z["num_heads"]),
                          num_kv_heads=int(z["num_kv_heads"]))
    for S in (2, 4):
        mesh = Mesh(devs[:S].reshape(1, S), ("data", "model"))
        for w in z["windows"].tolist():
            t = lambda k: jnp.asarray(z[f"{k}_{w}"])
            cache = KVCache(t("k"), t("v"), t("pos"))
            step = jax.jit(lambda q, k, v, c, p, _w=w, _m=mesh: _flash_decode(
                q, k, v, c, p, cfg=cfg, window=_w, mesh=_m))
            outs = []
            for i, pos in enumerate(z["steps"].tolist()):
                o, cache = step(t("q")[i], t("kn")[i], t("vn")[i], cache,
                                jnp.int32(pos))
                outs.append(np.asarray(o))
            res[f"o_{S}_{w}"] = np.stack(outs)
            for f in ("k", "v", "pos"):
                res[f"{f}_{S}_{w}"] = np.asarray(getattr(cache, f))
    np.savez(out, **res)
""")


def _layer_inputs(rng) -> dict:
    """One layer's decode inputs, float32: a ring of W = 8 slots holding
    positions 0-4 (slots 5-7 empty, so at S = 4 rank 3 starts dead), and
    five steps' q, k and v at positions 5-9."""
    z = {"num_heads": H, "num_kv_heads": HKV, "windows": np.asarray(WINDOWS),
         "steps": np.asarray(STEPS)}
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    for w in WINDOWS:
        pos = np.full(W, -1, np.int32)
        pos[:5] = np.arange(5)
        k, v = f(B, W, HKV, HD), f(B, W, HKV, HD)
        k[:, 5:] = v[:, 5:] = 0.0
        z.update({f"k_{w}": k, f"v_{w}": v, f"pos_{w}": pos,
                  f"q_{w}": f(len(STEPS), B, 1, H, HD),
                  f"kn_{w}": f(len(STEPS), B, 1, HKV, HD),
                  f"vn_{w}": f(len(STEPS), B, 1, HKV, HD)})
    return z


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("dist_decode")
    S, M, mb, dm = 2, 6, 4, 16
    pipe = {"Ws": (rng.standard_normal((S, dm, dm)) * dm ** -0.5).astype(
                np.float32),
            "bs": rng.standard_normal((S, dm)).astype(np.float32),
            "x": rng.standard_normal((M, mb, dm)).astype(np.float32)}
    np.savez(d / "pipe.npz", **pipe)
    np.savez(d / "layer.npz", **_layer_inputs(rng), **pipe)
    return d, pipe


@pytest.fixture(scope="module")
def reference(inputs):
    d, _ = inputs
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE,
                          str(d / "layer.npz"), str(d / "ref.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(d / "ref.npz"))


@pytest.fixture(scope="module")
def qwen(inputs):
    """The reduced Qwen3 (float32) of the reference's weights, saved for
    the ranks, tokens for 5 steps and JAX's default decode's logits."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import lm as jlm

    d, _ = inputs
    jcfg = j_get_config("qwen3-0.6b").reduced()
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    td.save_tree(d / "qwen.npz", tree)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (5, 2, 1)).astype(np.int32)
    caches = jlm.init_decode_caches(jcfg, 2, max_len=MAX_LEN)
    want = []
    for t in range(5):
        logits, caches = jlm.decode_step(params, jcfg, jnp.asarray(tokens[t]),
                                         caches, jnp.int32(t))
        want.append(np.asarray(logits, np.float32))
    return d / "qwen.npz", tree, tokens, np.stack(want)


@pytest.fixture(scope="module")
def worlds(inputs, qwen, tmp_path_factory):
    """Each world's ranks: the pipeline (world 2), placement, one layer's
    flash decode and the whole model's."""
    d, _ = inputs
    path, _, tokens, _ = qwen
    out = {}
    for world in WORLDS:
        out[world] = td.run_world(td.decode_world, world,
                                  tmp_path_factory.mktemp(f"w{world}"),
                                  str(d), str(path), tokens, MAX_LEN)
    return out


# ---------------------------------------------------------------- pipeline
def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 4) == 3 / 7
    assert bubble_fraction(2, 30) < 0.04


def test_pipeline_matches_sequential_and_reference(inputs, reference,
                                                   worlds):
    _, pipe = inputs
    want = pipe["x"]
    for s in range(2):
        want = np.tanh(want @ pipe["Ws"][s] + pipe["bs"][s])
    for r, res in enumerate(worlds[2]):
        got = res["pipe"]
        assert float(np.max(np.abs(got - want))) < 1e-5, r
        assert float(np.max(np.abs(got - reference["pipe"]))) < 1e-6, r


# --------------------------------------------------------------- placement
@pytest.mark.parametrize("world", WORLDS)
def test_shard_then_gather_is_whole(worlds, world):
    for r, res in enumerate(worlds[world]):
        p = res["placement"]
        model = world // 2
        assert p["('data', None)"] == ((4, 12, 3), True)
        assert p["(None, 'model')"] == ((8, 12 // model, 3), True)
        assert p["(('data', 'model'), None)"] == ((8 // world, 12, 3), True)
        assert p["()"] == ((8, 12, 3), True)
        assert all(ok for _, ok in (v for k, v in p.items()
                                    if k.startswith("(")))
        # the (pod, data) line of a (2, 1, world/2) mesh
        assert p["pod_data_ranks"] == [r % model, r % model + model]


@pytest.mark.parametrize("world", WORLDS)
def test_cross_rank_merge_breaks_ties_rank_major(worlds, world):
    """Gathered candidates stand rank-major, so ``merge_topk``'s stable
    order takes rank 0's first among equal keys, as ``lax.top_k`` takes
    the smaller index of the segment-major concatenation."""
    want = np.arange(12, dtype=np.int32).reshape(3, 4)
    for res in worlds[world]:
        np.testing.assert_array_equal(res["placement"]["tie_ids"], want)


# ------------------------------------------------------------ flash decode
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("world", WORLDS)
def test_flash_layer_matches_reference(reference, worlds, world, window):
    for r, res in enumerate(worlds[world]):
        o, (k, v, pos) = res["layer"][window]
        want = reference[f"o_{world}_{window}"]
        assert o.shape == want.shape == (len(STEPS), B, 1, H, HD)
        scale = float(np.max(np.abs(want)))
        assert float(np.max(np.abs(o - want))) <= 1e-5 * scale, r
        np.testing.assert_array_equal(k, reference[f"k_{world}_{window}"])
        np.testing.assert_array_equal(v, reference[f"v_{world}_{window}"])
        np.testing.assert_array_equal(pos,
                                      reference[f"pos_{world}_{window}"])


@pytest.mark.parametrize("world", WORLDS)
def test_flash_window_must_divide(worlds, world):
    assert "not divisible" in worlds[world][0]["layer"]["indivisible"]


@pytest.mark.parametrize("world", WORLDS)
def test_flash_model_matches_default_decode(qwen, worlds, world):
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_from_arrays

    _, tree, tokens, want = qwen
    model = lm_from_arrays(tree, get_config("qwen3-0.6b").reduced(),
                           device="cpu")
    caches = model.init_decode_caches(2, MAX_LEN)
    own = []
    with torch.no_grad():
        for t in range(5):
            logits, caches = model.decode_step(torch.as_tensor(tokens[t]),
                                               caches, t)
            own.append(logits.numpy())
    own = np.stack(own)
    scale = float(np.max(np.abs(want)))
    for r, res in enumerate(worlds[world]):
        got = res["model"]
        assert got.shape == want.shape
        assert float(np.max(np.abs(got - want))) <= 1e-5 * scale, r
        assert float(np.max(np.abs(got - own))) < 2e-2 * float(
            np.max(np.abs(own)))
        np.testing.assert_array_equal(got, worlds[world][0]["model"])
