"""The seed-lane K1/K2 with the lanes' split in the same launch
(``cuda_dropout.lane_dropout``, ``dropout_lanes_kernel`` and
``dropout_lanes_bwd_kernel`` in ``csrc/dropout.cu``), on the CPU: its plain
version against the layer entry followed by the lanes' split, bit for bit,
forward and backward, for every layout in and out; and numpy models of the
kernels' index arithmetic (the reciprocal row map past 2^31, the walk of a
vector across row ends, the lanes' operands)."""

import numpy as np
import pytest
import torch

from parallel_gcn_tpu_torch import seeds as sd
from parallel_gcn_tpu_torch.models.gcn import layer_entry
from parallel_gcn_tpu_torch.ops import cuda_dropout as cd

torch.set_num_threads(1)
SEEDS = [3, 11, 40, 0xFFFF_FFFF_FFFF_FFF1]
RATE = 0.3


def _inputs(layout, rows, width, dtype, gen):
    """(the kernel's input in ``layout``, the joined tensor it stands for,
    the leaf tensors)."""
    lanes = len(SEEDS)
    if layout == "shared":
        x = torch.randn(rows, width, generator=gen).to(dtype)
        return [x] * lanes, x.repeat(1, lanes), [x]
    joined = torch.randn(rows, lanes * width, generator=gen).to(dtype)
    if layout == "joined":
        return joined, joined, [joined]
    parts = [p.contiguous() for p in joined.chunk(lanes, dim=1)]
    return parts, joined, parts


@pytest.mark.parametrize("layout", ["joined", "lanes", "shared"])
@pytest.mark.parametrize("join", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# K2 (relu) takes no element offset, as relu_dropout
@pytest.mark.parametrize("relu, width, offset", [
    (False, 3, 0), (False, 41, 0), (False, 41, 8), (False, 64, 0),
    (True, 3, 0), (True, 41, 0), (True, 64, 0)])
def test_lane_dropout_is_the_entry_then_the_split(layout, join, relu, dtype, width, offset):
    rows, lanes = 29, len(SEEDS)
    gen = torch.Generator().manual_seed(width + 7 * offset)
    x, joined, leaves = _inputs(layout, rows, width, dtype, gen)
    slot = torch.tensor([s - 2**64 if s >= 2**63 else s for s in SEEDS], dtype=torch.int64)
    # the reference: the split of the joined tensor, then each lane's solo
    # layer entry with its seed
    ref_in = joined.clone().requires_grad_(True)
    ref_parts = [cd.dropout(p, slot[s], RATE, offset) if offset else
                 layer_entry(p, RATE, slot[s], True, relu)
                 for s, p in enumerate(sd._Split.apply(ref_in, lanes))]
    for leaf in leaves:
        leaf.requires_grad_(layout != "shared")
    got = cd.lane_dropout(x, slot, RATE, relu=relu, join=join, offset=offset)
    got_parts = got.chunk(lanes, dim=1) if join else got
    assert join == isinstance(got, torch.Tensor) and len(got_parts) == lanes
    for a, b in zip(got_parts, ref_parts):
        assert a.is_contiguous() or join
        assert torch.equal(a, b)
    # the same with the seeds as ints
    again = cd.lane_dropout(x, SEEDS, RATE, relu=relu, join=join, offset=offset)
    assert torch.equal(torch.cat(list(again), 1) if not join else again, torch.cat(got_parts, 1))
    if layout == "shared":  # an input every lane reads is data: no gradient
        return
    cot = [torch.randn(rows, width, generator=gen).to(dtype) for _ in range(lanes)]
    torch.autograd.backward(ref_parts, cot)
    torch.autograd.backward(got if join else list(got), torch.cat(cot, 1) if join else cot)
    if layout == "joined":
        assert torch.equal(leaves[0].grad, ref_in.grad)
    else:
        for s, leaf in enumerate(leaves):
            assert torch.equal(leaf.grad, ref_in.grad[:, s * width:(s + 1) * width])


def test_lane_dropout_k2_backward_is_torchs_where():
    """K2's backward over lanes is ``where(out > 0, g·(1/keep), 0)`` with
    1/keep a host scalar, lane by lane, in the input's layout."""
    gen = torch.Generator().manual_seed(1)
    lanes = len(SEEDS)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(17, lanes * 9, generator=gen).to(dtype)
        out = cd.lane_dropout(x, SEEDS, RATE, relu=True)
        g = [torch.randn(17, 9, generator=gen).to(dtype) for _ in range(lanes)]
        got = cd._run_lanes(g, None, RATE, 2, 0, lanes, True, aux=list(out))
        want = torch.cat([torch.where(o > 0, gs * cd._inv_keep(RATE, dtype), 0.0)
                          for o, gs in zip(out, g)], 1)
        assert torch.equal(got, want)


def test_lane_dropout_refusals():
    x = torch.randn(5, 8)
    with pytest.raises(ValueError, match="one joined tensor or one tensor a lane"):
        cd.lane_dropout([x, x], [1, 2, 3], 0.5)
    with pytest.raises(ValueError, match="one shape"):
        cd.lane_dropout([x, torch.randn(5, 7)], [1, 2], 0.5)
    with pytest.raises(ValueError, match="seed lanes need"):
        cd.lane_dropout(torch.randn(5, 7), [1, 2], 0.5)
    with pytest.raises(ValueError, match="rate in"):
        cd.lane_dropout(x, [1, 2], 0.0)


@pytest.mark.parametrize("join", [False, True])
def test_lane_dropout_takes_more_lanes_than_a_launch(join):
    """70 lanes (the kernel takes 64 a launch, then the rest with their
    seeds and columns): each lane its solo mask."""
    lanes, rows, width = 70, 6, 5
    gen = torch.Generator().manual_seed(70)
    x = torch.randn(rows, lanes * width, generator=gen)
    seeds = [1000 + 3 * s for s in range(lanes)]
    got = cd.lane_dropout(x, seeds, RATE, relu=True, join=join)
    parts = got.chunk(lanes, dim=1) if join else got
    assert len(parts) == lanes
    for s, part in enumerate(parts):
        want = cd.relu_dropout(x[:, s * width:(s + 1) * width].contiguous(), seeds[s], RATE)
        assert torch.equal(part, want)


@pytest.mark.parametrize("layout", ["joined", "lanes", "shared"])
@pytest.mark.parametrize("join", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_lane_entry_without_dropout_is_the_relu_and_the_layout(layout, join, relu):
    """``seeds.lane_entry`` where no dropout runs (an eval forward, a rate
    of 0): the deferred ReLU and the layout change, bit for bit those of the
    layer entry on the joined tensor and the split."""
    gen = torch.Generator().manual_seed(3)
    lanes = 3
    x, joined, _ = _inputs(layout, 7, 5, torch.float32, gen)
    x = x[:lanes] if isinstance(x, list) else x[:, :lanes * 5]
    joined = joined[:, :lanes * 5]
    h = x[0] if layout == "shared" else x
    for training, rate in ((False, 0.3), (True, 0.0)):
        got = sd.lane_entry(h, layout == "joined", lanes, rate, None, training, relu, join=join)
        want = torch.relu(joined) if relu else joined
        assert torch.equal(got if join else torch.cat(got, 1), want)
        assert join or len(got) == lanes


# ---------------------------------------------------------------------------
# the kernels' index arithmetic


def _magic(width: int) -> int:
    """The host's reciprocal of F (``launch_lanes``): floor((2^64-1)/F)+1."""
    return (2**64 - 1) // width + 1


def _row(j: int, width: int) -> int:
    """``lane_row``: the high word of j · magic (j itself for F = 1)."""
    return j if width == 1 else (j * _magic(width)) >> 64


@pytest.mark.parametrize("width", [1, 2, 3, 7, 41, 72, 600, 1433, 3703, 65537, 1_000_003])
def test_reciprocal_row_map_near_and_past_2_31(width):
    # the entry point's guard: rows · F < 2^63 and rows · F · F < 2^64
    max_rows = min((2**63 - 1) // width, (2**64 - 1) // width // width)
    n = max_rows * width  # the most elements a lane may have
    rng = np.random.default_rng(width)
    js = {0, 1, width - 1, width, n - 1, n - width}
    for edge in (2**31, 2**32, 2**40, 2**48):
        if edge < n:
            js |= {edge - 2, edge - 1, edge, edge + 1, edge + width}
    js |= {int(v) for v in rng.integers(0, n, 200, dtype=np.uint64)}
    for j in sorted(v for v in js if 0 <= v < n):
        r = _row(j, width)
        assert r == j // width, (j, width)
        assert 0 <= j - r * width < width


@pytest.mark.parametrize("width", [1, 3, 5, 8, 41])
@pytest.mark.parametrize("kvec", [4, 8])
def test_vector_walk_carries_the_row_across_row_ends(width, kvec):
    """A vector's elements j .. j+kVec-1 walked from (r, c) of j, the row
    carried at each row end, are (j+e) // F, (j+e) % F, across several rows
    when F < kVec."""
    for v in range(0, 3 * width + 5):
        j = v * kvec
        r, c = _row(j, width), j - _row(j, width) * width
        for e in range(kvec):
            assert (r, c) == divmod(j + e, width)
            c += 1
            if c == width:
                c, r = 0, r + 1


def _refs(layout: str, lanes: int, rows: int, width: int, esize: int, base: int = 0):
    """(lane bases in elements, row stride, vec) of a laned operand as
    ``fill_refs`` makes them: a joined tensor, lane-contiguous tensors at
    16-byte aligned bases, or one shared tensor."""
    kvec = 16 // esize
    if layout == "joined":
        bases = [base + s * width for s in range(lanes)]
        ld = lanes * width
    else:
        step = -(-rows * width * esize // 256) * 256 // esize  # the allocator's spacing
        bases = [base + (0 if layout == "shared" else s * step) for s in range(lanes)]
        ld = width
    vec = ld == width or (width % kvec == 0 and ld % kvec == 0)
    vec = vec and all((b * esize) % 16 == 0 for b in bases)
    return bases, ld, vec


@pytest.mark.parametrize("src, dst", [("joined", "lanes"), ("lanes", "joined"),
                                      ("shared", "lanes"), ("shared", "joined"),
                                      ("joined", "joined"), ("lanes", "lanes")])
@pytest.mark.parametrize("width, dtype", [(3, torch.float32), (41, torch.bfloat16),
                                          (64, torch.bfloat16), (24, torch.float32)])
@pytest.mark.parametrize("offset", [0, 8])
def test_lanes_kernel_index_model(src, dst, width, dtype, offset):
    """The lanes kernel walked in numpy: a block row a lane, 16-byte vectors
    of the lane's own index j = r·F + c on whole Philox counters (counter
    offset/4 + v·kVec/4 + e/4, word e % 4); each operand's element at its
    base + j (lane-contiguous) or base + r·ld + c (joined, (r, c) from the
    reciprocal and the walk), 16-byte accesses only where ``vec`` says and
    then aligned and inside one row. Every output element is written once,
    with lane s's solo mask: the plain version's values."""
    lanes, rows = 3, 11
    esize = torch.tensor([], dtype=dtype).element_size()
    kvec, n = 16 // esize, rows * width
    seeds = SEEDS[:lanes]
    gen = torch.Generator().manual_seed(width)
    in_b, in_ld, in_vec = _refs(src, lanes, rows, width, esize)
    out_b, out_ld, out_vec = _refs(dst, lanes, rows, width, esize, base=10**6)
    x_mem = torch.randn(10**6, generator=gen).to(dtype)
    out_mem = {}
    thr = cd.keep_threshold(RATE)
    inv = cd._inv_keep(RATE, dtype)
    words = [cd.philox_words(s, n, "cpu", offset) for s in seeds]

    def addr(bases, ld, s, j):
        if ld == width:
            return bases[s] + j
        r = _row(j, width)
        return bases[s] + r * ld + (j - r * width)

    j = np.arange(-(-n // kvec) * kvec)
    v, e = j // kvec, j % kvec
    ctr = torch.from_numpy(offset // 4 + v * (kvec // 4) + e // 4)
    zero = torch.zeros_like(ctr)
    for s in range(lanes):  # blockIdx.y
        for j0 in range(0, n, kvec):
            for vec, bases, ld in ((in_vec, in_b, in_ld), (out_vec, out_b, out_ld)):
                if vec and j0 + kvec <= n:  # one 16-byte access
                    a = addr(bases, ld, s, j0)
                    assert (a * esize) % 16 == 0
                    assert ld == width or addr(bases, ld, s, j0 + kvec - 1) == a + kvec - 1
        # counter offset/4 + v·kVec/4 + e/4, word e % 4: the solo words at j
        w4 = cd.philox4x32_10(ctr & 0xFFFFFFFF, ctr >> 32, zero, zero, seeds[s] & 0xFFFFFFFF,
                              seeds[s] >> 32)
        word = torch.stack(w4, 1)[torch.arange(len(j)), torch.from_numpy(e % 4)][:n]
        assert torch.equal(word, words[s])
        for jj in range(n):
            o = addr(out_b, out_ld, s, jj)
            assert o not in out_mem
            out_mem[o] = torch.where(word[jj] < thr, x_mem[addr(in_b, in_ld, s, jj)] * inv, 0.0)
    assert len(out_mem) == lanes * n
    xin = [x_mem[torch.tensor([addr(in_b, in_ld, s, j) for j in range(n)])].view(rows, width)
           for s in range(lanes)]
    want = cd.lane_dropout_plain(xin, seeds, RATE, 0, offset, lanes, False)
    for s in range(lanes):
        got = torch.stack([out_mem[addr(out_b, out_ld, s, j)] for j in range(n)]).view(rows, width)
        assert torch.equal(got, want[s])
