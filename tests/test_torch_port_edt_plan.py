"""The EDT kernel's O(n) lower envelope, transcribed to numpy line by line
(``csrc/edt_envelope.cu``): the integer path (Felzenszwalb-Huttenlocher,
entries ``c = g + v²``, separators compared by integer cross-products, the
line cut into bands whose stacks one thread joins) for lines at unit
sampling with integer entries below 2^18, else the float
path (Meijster's two phases with the integer region start ``floor(x) + 1``
from one fp32 division); entries >= 1e12 left out, the fill evaluating
``g[v] + ((i − v)·s)²`` step by step in fp32. Held against the scan
(``envelope_plain``) and the JAX package's ``ops/edt.py:_envelope_1d``:
bit for bit at sampling 1 on integer lines (both paths), within rtol 1e-6
at 1.5 and 2. The mask pass (forward and backward sweeps
to the nearest False) is held to the scan of ``where(mask, 1e12, 0)`` bit
for bit at every sampling, and ``envelope_mask`` to the fp32 path. The CUDA
kernels themselves run only on a card (tests/test_torch_port_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brats21_tpu.ops import edt as jedt
from brats21_tpu_torch.ops import edt as pedt
from brats21_tpu_torch.ops.kernels import edt as kedt
from test_torch_port_kernels import one_torch_thread  # noqa: F401  (autouse)

F = np.float32
INF = F(kedt.INF)


def _cand(g, i, v, s):
    d = F(F(F(i) - F(v)) * s)
    return F(g + F(d * d))


INT_MAX = F(2 ** 18)


def is_int_line(g, s):
    """The kernel's choice of the integer path."""
    fin = g[g < INF]
    return s == 1.0 and bool(np.all((fin >= 0) & (fin < INT_MAX) & (fin == np.rint(fin))))


def envelope_line(g, s):
    """The kernel's general pass over one fp32 line."""
    return envelope_line_banded(g) if is_int_line(g, s) else envelope_line_float(g, s)


BANDS = 4


def _pops(a, b, u):
    """FH: the top b goes when its region (sep(a, b), sep(b, u)) is empty."""
    (ca, va), (cb, vb), (cu, vu) = a, b, u
    assert abs((cu - cb) * (vb - va)) < 2 ** 30 and abs((cb - ca) * (vu - vb)) < 2 ** 30
    return (cu - cb) * (vb - va) <= (cb - ca) * (vu - vb)


def envelope_line_banded(g, bands=BANDS):
    """The kernel's integer path: each band of the line builds its own
    stack in its own slots, one thread merges them into at most `bands`
    contiguous slot segments, each band fills its own positions."""
    n = len(g)
    slots = [None] * n                            # (c, v)
    lo, hi = [0] * bands, [-1] * bands
    for b in range(bands):
        b0, b1 = b * n // bands, (b + 1) * n // bands
        k = b0 - 1
        for u in range(b0, b1):
            if not g[u] < INF:
                continue
            e = (int(g[u]) + u * u, u)
            while k >= b0 + 1 and _pops(slots[k - 1], slots[k], e):
                k -= 1
            k += 1
            slots[k] = e
        lo[b], hi[b] = b0, k

    def top_two(last):
        """Slots of the top entry and the one below it, over segments 0..last."""
        found = []
        for b in range(last, -1, -1):
            for sl in range(hi[b], lo[b] - 1, -1):
                found.append(sl)
                if len(found) == 2:
                    return found
        return found + [None] * (2 - len(found))

    for b in range(1, bands):
        m_lo, m_hi = lo[b], hi[b]
        hi[b] = m_lo - 1
        for j in range(m_lo, m_hi + 1):
            while True:
                t, sec = top_two(b)
                if sec is None or not _pops(slots[sec], slots[t], slots[j]):
                    break
                tb = max(x for x in range(b + 1) if lo[x] <= t <= hi[x])
                hi[tb] -= 1
            if hi[b] == j - 1 and hi[b] >= lo[b]:
                hi[b] = m_hi                      # on its local neighbour: the rest is local
                break
            lo[b] = hi[b] = j
    order = [sl for b in range(bands) for sl in range(lo[b], hi[b] + 1)]
    out = np.full(n, INF, F)
    if not order:
        return out
    ent = [slots[sl] for sl in order]
    for b in range(bands):
        b0, b1 = b * n // bands, (b + 1) * n // bands
        if b0 >= b1:
            continue
        # the last entry at least as good at b0 as the one before it
        lo_r, hi_r = 0, len(ent) - 1
        while lo_r < hi_r:
            mid = (lo_r + hi_r + 1) // 2
            if ent[mid][0] - ent[mid - 1][0] < 2 * b0 * (ent[mid][1] - ent[mid - 1][1]):
                lo_r = mid
            else:
                hi_r = mid - 1
        r = lo_r
        for i in range(b0, b1):
            while r + 1 < len(ent) and ent[r + 1][0] - ent[r][0] < 2 * i * (
                    ent[r + 1][1] - ent[r][1]):
                r += 1
            c, v = ent[r]
            out[i] = min(INF, _cand(F(c - v * v), i, v, F(1)))
    return out


def envelope_line_float(g, s):
    """The float path: Meijster's walk with an fp32 separator."""
    n, s = len(g), F(s)
    s2 = F(s * s)
    stack = []                                   # (vertex, start, g[vertex])
    for u in range(n):
        gu = g[u]
        if not gu < INF:
            continue
        while stack and _cand(gu, stack[-1][1], u, s) < _cand(stack[-1][2], stack[-1][1],
                                                               stack[-1][0], s):
            stack.pop()
        w = 0
        if stack:
            tv, tt, tg = stack[-1]
            num = F(F(gu - tg) + F(s2 * F(u * u - tv * tv)))
            x = F(num / F(s2 * F(2 * (u - tv))))
            if not x < n:
                continue
            w = max(int(np.floor(x)) + 1, tt + 1)
            if w >= n:
                continue
        stack.append((u, w, gu))
    out = np.full(n, INF, F)
    if not stack:
        return out
    k = len(stack) - 1
    for u in range(n - 1, -1, -1):
        v, t, gv = stack[k]
        out[u] = min(INF, _cand(gv, u, v, s))
        if u == t and k > 0:
            k -= 1
    return out


def mask_line_banded(m, s, bands=BANDS):
    """The kernel's mask pass as it runs: each band sweeps its own
    positions, starting from the nearest False of the bands beside it."""
    n, far = len(m), 1 << 28
    ranges = [(b * n // bands, (b + 1) * n // bands) for b in range(bands)]
    false_at = [[u for u in range(b0, b1) if not m[u]] for b0, b1 in ranges]
    out = np.empty(n, F)
    for b, (b0, b1) in enumerate(ranges):
        last = max([f[-1] for f in false_at[:b] if f], default=-far)
        nxt = min([f[0] for f in false_at[b + 1:] if f], default=2 * far)
        left = {}
        for u in range(b0, b1):
            if not m[u]:
                last = u
            left[u] = min(u - last, far)
        for u in range(b1 - 1, b0 - 1, -1):
            if left[u] == 0:
                nxt = u
            d = min(left[u], nxt - u)
            out[u] = INF if d >= far else min(INF, _cand(F(0), d, 0, F(s)))
    return out


def _lines(kind, n, seed):
    """Seeded lines of the kinds the passes meet: squared distances with
    the 1e12 sentinel."""
    rng = np.random.default_rng(seed)
    if kind == "all_sentinel":
        return np.full((4, n), INF, F)
    if kind == "single_finite":
        g = np.full((4, n), INF, F)
        g[np.arange(4), rng.integers(0, n, 4)] = rng.integers(0, 400, 4)
        return g
    if kind == "alternating":
        g = np.where(np.arange(n) % 2 == 0, F(0), INF)[None].repeat(4, 0).astype(F)
        g[1, 1::2] = rng.integers(0, 9, g[1, 1::2].shape)
        return g
    if kind == "sentinel_runs":
        runs = np.cumsum(rng.integers(1, 12, (4, n)), axis=1) // 7 % 2 == 1
        return np.where(runs, INF, rng.integers(0, 3 * n * n, (4, n))).astype(F)
    # random squared distances, a few of them sentinels, ends included
    g = rng.integers(0, 139226, (4, n)).astype(F)
    g[rng.random((4, n)) < 0.2] = INF
    g[0, 0] = g[0, -1] = 0
    return g


KINDS = ["all_sentinel", "single_finite", "alternating", "sentinel_runs", "random"]
LENGTHS = [1, 2, 3, 128, 155, 240]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_envelope_plan_equals_scan_at_unit_sampling(kind, n):
    """Both paths, bit for bit: the integer path the kernel takes on these
    lines, and the float path it takes on lines outside its preconditions."""
    g = _lines(kind, n, 10 * n + KINDS.index(kind))
    want = kedt.envelope_plain(torch.from_numpy(g), 1.0).numpy()
    np.testing.assert_array_equal(want, np.asarray(jedt._envelope_1d(jnp.asarray(g), 1.0)))
    assert all(is_int_line(line, 1.0) for line in g)
    for bands in (1, 2, BANDS, 7):
        np.testing.assert_array_equal(
            np.stack([envelope_line_banded(line, bands) for line in g]), want)
    np.testing.assert_array_equal(np.stack([envelope_line_float(line, 1.0) for line in g]),
                                  want)


def test_envelope_plan_takes_the_float_path_off_the_integers():
    """Halves, negatives and values at 2^18 send a line to the float path,
    which then holds the scan within rtol 1e-6 (bit for bit here)."""
    g = _lines("random", 155, 3)
    g[0, 5] = 2.5
    g[1, 7] = -1.0
    g[2, 9] = INT_MAX
    assert not any(is_int_line(line, 1.0) for line in g[:3]) and is_int_line(g[3], 1.0)
    assert not is_int_line(g[3], 1.5)
    want = kedt.envelope_plain(torch.from_numpy(g), 1.0).numpy()
    np.testing.assert_allclose(np.stack([envelope_line(line, 1.0) for line in g]), want,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [3, 128, 155, 240])
@pytest.mark.parametrize("sampling", [1.5, 2.0])
def test_envelope_plan_within_rtol_at_other_samplings(sampling, n):
    for kind in KINDS:
        g = _lines(kind, n, n + KINDS.index(kind))
        want = kedt.envelope_plain(torch.from_numpy(g), sampling).numpy()
        got = np.stack([envelope_line(line, sampling) for line in g])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=kind)


@pytest.mark.parametrize("sampling", [1.0, 1.5, 2.0])
def test_mask_plan_equals_scan_bit_for_bit(sampling):
    rng = np.random.default_rng(int(10 * sampling))
    for n in LENGTHS:
        masks = rng.random((6, n)) > 0.5
        masks[0] = True                      # no False: the sentinel line
        masks[1] = False
        masks[2, :] = True
        masks[2, 0] = masks[2, -1] = False   # False at both ends only
        want = kedt.envelope_mask_plain(torch.from_numpy(masks), sampling).numpy()
        for bands in (1, 2, BANDS, 7):
            got = np.stack([mask_line_banded(m, sampling, bands) for m in masks])
            np.testing.assert_array_equal(got, want, err_msg=f"n={n}, {bands} bands")


@pytest.mark.parametrize("sampling", [1.0, 1.5])
def test_edt_sq_passes_follow_the_plan(sampling):
    """edt_sq's three passes (mask pass, then two general passes), each
    through the transcription along its axis, equal edt_sq on the CPU: bit
    for bit at unit sampling, rtol 1e-6 otherwise."""
    masks = np.random.default_rng(5).random((2, 9, 13, 11)) > 0.3
    masks[1, :, :, 4] = True
    s = (1.0, 1.0, sampling)
    f = np.apply_along_axis(mask_line_banded, 1, masks, s[0])
    for ax in (2, 3):
        f = np.apply_along_axis(envelope_line, ax, f, s[ax - 1])
    want = pedt.edt_sq(torch.from_numpy(masks), s).numpy()
    if sampling == 1.0:
        np.testing.assert_array_equal(f, want)
    else:
        np.testing.assert_allclose(f, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_envelope_mask_equals_the_fp32_path(axis):
    """envelope_mask (bool in) equals envelope on where(mask, 1e12, 0) bit
    for bit along any axis, from a strided (permuted) mask too."""
    masks = np.random.default_rng(6).random((7, 12, 5)) > 0.4
    m = torch.from_numpy(masks)
    want = kedt.envelope(torch.where(m, kedt.INF, 0.0), 1.5, axis)
    np.testing.assert_array_equal(kedt.envelope_mask(m, 1.5, axis).numpy(), want.numpy())
    mt = m.permute(2, 0, 1)
    want_t = kedt.envelope(torch.where(mt, kedt.INF, 0.0).contiguous(), 1.0, axis)
    np.testing.assert_array_equal(kedt.envelope_mask(mt, 1.0, axis).numpy(), want_t.numpy())
