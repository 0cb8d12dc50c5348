"""The whole-run path (``mode=scan``) of parallel_gcn_tpu_torch.

Against the JAX package's ``fit(mode=scan)`` at dropout 0, from JAX's initial
weights (its key schedule) on the same numpy-seeded graph, Pallas in
interpret mode: the deferred-eval schedule (k = 0, two layers, int8 tile
pack), the plain schedule (one layer with input pre-aggregation), the
early-stopping loop where it fires and the GAT. Histories agree within
1e-5 and ``epochs_run`` is equal.

Against the port's eager loop at nonzero dropout (the same seeds draw the
same masks): GCN, fused GCN and GAT histories within 1e-5, the single-epoch
deferred run, and the state frozen after an early stop. Plus the device Adam
step against JAX's ``adam_step`` over 50 steps, the seed slots against int
seeds in the plain dropout and hash versions (and K1's and K2's recorded
output digests), and, on an NVIDIA GPU only, the captured epoch's replays
against the eager loop and each seed-slot kernel against its plain version.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gcn_tpu.ops.pallas_bcsr as pb
from parallel_gcn_tpu import train as jtrain
from parallel_gcn_tpu.config import Config as JaxConfig
from parallel_gcn_tpu.data.parser import to_device as jax_to_device
from parallel_gcn_tpu.optim import adam_step as jax_adam_step
from parallel_gcn_tpu.optim import init_adam as jax_init_adam
from parallel_gcn_tpu_torch import train as ttrain
from parallel_gcn_tpu_torch.config import Config
from parallel_gcn_tpu_torch.convert import params_from_numpy
from parallel_gcn_tpu_torch.data.parser import to_device
from parallel_gcn_tpu_torch.data.synthetic import make_synthetic_dataset
from parallel_gcn_tpu_torch.ops import cuda_dropout, cuda_fused, tile_attention
from parallel_gcn_tpu_torch.optim import adam_step, init_adam
from parallel_gcn_tpu_torch.scan import POLL_EPOCHS

torch.set_num_threads(1)

CPU = torch.device("cpu")
TILES = dict(hybrid=True, tile_dtype="int8", tile_size=128, min_tile_nnz=520)


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    old = pb._INTERPRET[0]
    pb._INTERPRET[0] = pltpu.InterpretParams()
    yield
    pb._INTERPRET[0] = old


def _dataset():
    return make_synthetic_dataset(
        "scan", n_nodes=500, n_edges=8000, input_dim=24, n_classes=6,
        n_train=280, n_val=100, feature_nnz_per_row=8, n_communities=6,
    )


def _config(cfg, *, epochs, hidden=(16,), dropouts=(0.0, 0.0), k=0, backend="hybrid",
            gat=False, lr=0.01, mode="scan"):
    cfg.gcn.hidden_dims, cfg.gcn.dropouts = hidden, dropouts
    cfg.gcn.n_layers = len(dropouts)
    cfg.gcn.epochs, cfg.gcn.early_stopping = epochs, k
    cfg.adam.learning_rate, cfg.adam.weight_decay = lr, 5e-4
    cfg.tpu.backend, cfg.tpu.tile_dtype = backend, "int8"
    cfg.tpu.tile_size, cfg.tpu.min_tile_nnz = 128, 520
    cfg.tpu.matmul_precision = "highest"
    cfg.train.verbose, cfg.train.mode = False, mode
    if gat:
        cfg.gcn.model, cfg.gcn.heads = "gat", 2
    return cfg


# (schedule, config keywords): the three schedules of JAX's _make_scan_run
JAX_CASES = {
    "deferred": dict(epochs=8),
    "plain one layer": dict(epochs=8, hidden=(), dropouts=(0.0,)),
    "early stopping": dict(epochs=60, k=3, lr=0.5, backend="segment"),
    "gat": dict(epochs=8, hidden=(8,), gat=True, backend="segment"),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_scan_matches_jax_scan(case):
    kw = JAX_CASES[case]
    ds = _dataset()
    layout = TILES if kw.get("backend", "hybrid") == "hybrid" else {}
    jcfg = _config(JaxConfig(), **kw)
    jres = jtrain.fit(jcfg, jax_to_device(ds, **layout))
    # JAX fit's initial weights: the init half of its key's first split
    _, init_key = jax.random.split(jax.random.PRNGKey(jcfg.tpu.seed))
    w = jax.tree.map(np.asarray, jtrain.init_model_params(jcfg, init_key, ds.input_dim,
                                                          ds.output_dim))
    weights = params_from_numpy(w, CPU)
    tres = ttrain.fit(_config(Config(), **kw), to_device(ds, device=CPU, **layout),
                      weights=weights)
    assert tres.epochs_run == jres.epochs_run
    if case == "early stopping":
        assert tres.epochs_run < kw["epochs"]
    np.testing.assert_allclose(tres.history, np.asarray(jres.history), rtol=0, atol=1e-5)
    assert tres.test_acc == pytest.approx(float(jres.test_acc), abs=1e-6)


# (path, config keywords) at nonzero dropout: scan against the port's eager loop
EAGER_CASES = {
    "gcn": dict(dropouts=(0.3, 0.3)),
    "gcn shared prefix": dict(dropouts=(0.0, 0.3)),
    "fused gcn": dict(dropouts=(0.3, 0.3), fused=True),
    "gat": dict(dropouts=(0.3, 0.3), hidden=(8,), gat=True),
    "single epoch": dict(dropouts=(0.0, 0.3), epochs=1),
}


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_scan_matches_eager_with_dropout(case):
    kw = dict(EAGER_CASES[case])
    fused = kw.pop("fused", False)
    kw.setdefault("epochs", 6)
    dds = to_device(_dataset(), device=CPU, **TILES)
    res = {}
    for mode in ("scan", "eager"):
        cfg = _config(Config(), mode=mode, **kw)
        if fused:
            cfg.tpu.ce_impl, cfg.tpu.fuse_dropout_matmul = "pallas", True
        if kw.get("gat"):
            cfg.gcn.attn_dropout = 0.3
        res[mode] = ttrain.fit(cfg, dds)
    assert res["scan"].history.shape == (kw["epochs"], 4)
    np.testing.assert_allclose(res["scan"].history, res["eager"].history, rtol=0, atol=1e-5)
    assert res["scan"].test_acc == pytest.approx(res["eager"].test_acc, abs=1e-6)


def test_schedule_choice():
    dds = to_device(_dataset(), device=CPU, **TILES)
    cases = [(dict(epochs=5), (0, True)), (dict(epochs=5, k=3), (3, False)),
             (dict(epochs=5, k=9), (0, True)),  # k > epochs can never fire
             (dict(epochs=5, hidden=(), dropouts=(0.0,)), (0, False)),
             (dict(epochs=5, hidden=(8,), gat=True), (0, False))]
    for kw, want in cases:
        cfg = _config(Config(), **kw)
        assert ttrain.scan_schedule(ttrain.build_model(cfg, dds), cfg) == want, kw


def test_state_frozen_after_an_early_stop():
    """The epochs queued after the stop (up to two chunks of POLL_EPOCHS on
    the CPU) leave weights, moments and the step count as the stopping
    epoch left them: the eager loop's final state."""
    dds = to_device(_dataset(), device=CPU)
    cfg = _config(Config(), epochs=60, k=3, lr=0.5, backend="segment", dropouts=(0.0, 0.2))
    model = ttrain.build_model(cfg, dds)
    dds = ttrain.preaggregate_input(model, dds)
    opt = init_adam(list(model.weights))
    loop = ttrain.make_scan_loop(model, cfg, dds, opt,
                                 torch.Generator().manual_seed(cfg.tpu.seed))
    res = loop.run()
    assert res.epochs_run < loop.queued <= res.epochs_run + 2 * POLL_EPOCHS
    assert int(opt.step) == res.epochs_run
    cfg.train.mode = "eager"
    eager = ttrain.fit(cfg, to_device(_dataset(), device=CPU))
    assert eager.epochs_run == res.epochs_run
    np.testing.assert_allclose(res.history, eager.history, rtol=0, atol=1e-5)
    for a, b in zip(model.weights, eager.weights):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_device_adam_matches_jax_over_50_steps():
    rng = np.random.default_rng(5)
    shapes = [(12, 8), (8, 4)]
    w_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=0.01, weight_decay=5e-4, beta1=0.9, beta2=0.999, eps=1e-8)
    tw = [torch.from_numpy(w.copy()) for w in w_np]
    ts = init_adam(tw)
    jw = [jnp.asarray(w) for w in w_np]
    js = jax_init_adam(jw)
    for _ in range(50):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        adam_step(tw, [torch.from_numpy(a) for a in g], ts, **kw)
        jw, js = jax_adam_step(jw, [jnp.asarray(a) for a in g], js, **kw)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 50
    for t, j in zip(tw + ts.m + ts.v, jw + list(js.m) + list(js.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-9)


def _det_input(shape, dtype):
    """Integer-generated values, the same on every machine and version."""
    i = torch.arange(int(np.prod(shape)), dtype=torch.int64)
    return (((i * 2654435761) % 2001 - 1000).to(torch.float32) / 37.0).view(shape).to(dtype)


def _digest(t: torch.Tensor) -> str:
    bits = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


# sha256 prefixes of K1's and K2's outputs (the plain version, which the card
# holds bit-equal to the kernels) at seed 0x123456789ABC: the mask contract's
# bits, recorded before the kernels' seed moved to device memory:
# (shape, dtype, rate) -> (K1, K2)
DROPOUT_DIGESTS = {
    ((4099, 600), torch.bfloat16, 0.1): ("5d86b06a3c58a892", "430f751c272e9819"),
    ((1001, 257), torch.float32, 0.3): ("f03ceb28303e79c9", "069be357f1fecea1"),
}


@pytest.mark.parametrize("key", list(DROPOUT_DIGESTS), ids=["bf16", "f32"])
def test_seed_slots_draw_the_int_seeds_bits(key):
    shape, dtype, rate = key
    seed = 0x1234_5678_9ABC
    x = _det_input(shape, dtype)
    slot = torch.tensor([7, seed, 3], dtype=torch.int64)[1]  # a 0-d view, as SeedSlots gives
    for relu, want in zip((False, True), DROPOUT_DIGESTS[key]):
        by_int = cuda_dropout.dropout_plain(x, seed, rate, relu=relu)
        by_slot = cuda_dropout.dropout_plain(x, slot, rate, relu=relu)
        assert torch.equal(by_int, by_slot)
        assert _digest(by_slot) == want
    # the wrappers (plain on the CPU), the int32 cast a GAT's K1 takes, K10
    assert torch.equal(cuda_dropout.dropout(x, slot, rate), cuda_dropout.dropout(x, seed, rate))
    small = torch.tensor(12345, dtype=torch.int32)
    assert torch.equal(cuda_dropout.dropout(x, small, rate), cuda_dropout.dropout(x, 12345, rate))
    w = _det_input((shape[1], 5), dtype)
    assert torch.equal(cuda_fused.dropout_matmul_plain(x, w, slot, rate),
                       cuda_fused.dropout_matmul_plain(x, w, seed, rate))


def test_attention_hash_from_a_slot():
    rng = np.random.default_rng(3)
    dest = torch.from_numpy(rng.integers(0, 2**20, 5000))
    src = torch.from_numpy(rng.integers(0, 2**20, 5000))
    for seed in (0, 12345, 2**31 - 2):
        slot = torch.tensor([seed], dtype=torch.int32)[0]
        for h in range(3):
            want = tile_attention.hash_keep(dest, src, h, seed, 2**31)
            assert torch.equal(tile_attention.hash_keep(dest, src, h, slot, 2**31), want)
    with pytest.raises(ValueError):
        cuda_dropout.seed_tensor(torch.tensor([1, 2]), CPU)
    with pytest.raises(ValueError):
        cuda_dropout.seed_tensor(2**64, CPU)
    assert int(cuda_dropout.seed_tensor(2**64 - 1, CPU)) == -1  # the uint64's bits


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels; no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["gcn", "gat", "early stopping"])
def test_captured_replays_match_the_eager_loop(card, path):
    kw = {"gcn": dict(dropouts=(0.0, 0.3)), "gat": dict(dropouts=(0.3, 0.3), hidden=(8,),
                                                        gat=True),
          "early stopping": dict(epochs=40, k=3, lr=0.5, dropouts=(0.0, 0.2))}[path]
    kw.setdefault("epochs", 6)
    dds = to_device(_dataset(), device=card, **TILES)
    res = {}
    for mode in ("scan", "eager"):
        res[mode] = ttrain.fit(_config(Config(), mode=mode, **kw), dds)
    assert res["scan"].replays == res["scan"].epochs_run - 1 or path == "early stopping"
    assert res["scan"].graph_launches
    assert res["scan"].epochs_run == res["eager"].epochs_run
    np.testing.assert_allclose(res["scan"].history, res["eager"].history, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_seed_slot_kernels_match_plain(card):
    """Through a seed slot on the card: K1 and K2 bit-equal to their plain
    versions (and the recorded digests); K10's mask, which an identity W
    recovers, bit-equal to K1's, and its three kernels bit-equal to the
    same kernels given the int seed; K5 and K6 bit-equal to themselves given
    the int seed."""
    seed = 0x1234_5678_9ABC
    slot = torch.tensor([0, seed], dtype=torch.int64, device=card)[1]
    for key, (k1, k2) in DROPOUT_DIGESTS.items():
        shape, dtype, rate = key
        x = _det_input(shape, dtype).to(card)
        assert torch.equal(cuda_dropout.dropout(x, slot, rate),
                           cuda_dropout.dropout_plain(x, seed, rate))
        assert _digest(cuda_dropout.dropout(x, slot, rate)) == k1
        assert _digest(cuda_dropout.relu_dropout(x, slot, rate)) == k2
        eye = torch.eye(shape[1], dtype=dtype, device=card)
        assert torch.equal(cuda_fused.dropout_matmul(x, eye, slot, rate),
                           cuda_dropout.dropout(x, slot, rate).float())
        w = _det_input((shape[1], 41), dtype).to(card)
        g = _det_input((shape[0], 41), torch.float32).to(card) / shape[0]
        for fn in (lambda s: cuda_fused._fwd(x, w, s, rate),
                   lambda s: cuda_fused._dw(x, g, s, rate, dtype),
                   lambda s: cuda_fused._dx(g, w, s, rate, dtype)):
            assert torch.equal(fn(slot), fn(seed))
    dds = to_device(_dataset(), device=card, **TILES)
    pack, n = dds.graph.bcsr, dds.graph.n_nodes
    gen = torch.Generator().manual_seed(0)
    s_, t_ = (torch.randn((n, 2), generator=gen).to(card) for _ in range(2))
    v = torch.randn((n, 2, 8), generator=gen).to(card)
    aslot = torch.tensor([0, 2468], dtype=torch.int32, device=card)[1]
    by = {s: tile_attention.gat_fwd_tiles(pack, s_, t_, v, slope=0.2, rate=0.5, seed=s)
          for s in (aslot, 2468)}
    assert all(map(torch.equal, by[aslot], by[2468]))
    acc, m, den = by[2468]
    rho = torch.randn_like(m)
    bw = {s: tile_attention.gat_bwd_tiles(pack, s_, t_, v, v, m, den, rho, slope=0.2,
                                          rate=0.5, seed=s) for s in (aslot, 2468)}
    assert all(map(torch.equal, bw[aslot], bw[2468]))
