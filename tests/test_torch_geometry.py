"""PyTorch port: the launch geometry of the redesigned CUDA kernels, on the
CPU.

The K3 / K4 sweeps visit only the hull [lo_k, lo_k + width_k) of each
anti-diagonal's admissible positions, K1 / K2 run one thread per pair for
tiles of 8-32, and K6 runs one thread per pair for strips of up to 64
cells, a lane group per pair up to 256 and wider strips through shared
memory. Each picks its template from a pure-Python helper
(``krdtw_geometry``, ``tile_geometry``, ``banded_geometry``); these tests
hold the helpers to the support they are given and to the card's 232,448
bytes of shared memory per block, at every length the reference takes
(T up to 2709, UCR HandOutlines). They also hold the wide strip's plain
version to the reference's Pallas kernel (interpret mode, bit for bit: min
and add only), which the card's kernel is held to in turn.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dtw_banded as t_k6
from repro_torch.kernels import krdtw_wavefront as t_k4
from repro_torch.kernels.spdtw_block import tile_geometry

SMEM_MAX = 232448
# floats a thread may hold in register arrays (the card's 255 registers,
# less room for addresses, counters and the cost's temporaries)
REG_FLOATS_MAX = 160


def _path_support(T, n_paths, seed):
    """A learned-style support: the union of random monotone warping paths
    from (0, 0) to (T-1, T-1) (a learned support is the union of the
    training pairs' optimal paths)."""
    rng = np.random.default_rng(seed)
    sup = np.zeros((T, T), bool)
    for _ in range(n_paths):
        i = j = 0
        sup[0, 0] = True
        while (i, j) != (T - 1, T - 1):
            step = rng.integers(3)
            if i == T - 1 or (step == 1 and j < T - 1 and j - i < 6):
                j += 1
            elif j == T - 1 or (step == 2 and i - j < 6):
                i += 1
            else:
                i, j = i + 1, j + 1
            sup[i, j] = True
    return sup


DOMAINS = ["full", "radius0", "radius6", "radius204", "learned"]


@pytest.mark.parametrize("T", [24, 128, 1024, 2709])
@pytest.mark.parametrize("domain", DOMAINS)
def test_krdtw_hull_covers_every_admissible_cell(T, domain):
    radius = {"radius0": 0, "radius6": 6, "radius204": 204}.get(domain)
    md = None
    if domain == "learned":
        md = t_k4.mask_to_diagonal_major(_path_support(T, 4, T)) > 0
    bits = None if md is None else t_k4.pack_diagonal_mask(md, T, "cpu")
    geo = t_k4.krdtw_geometry(T, radius, bits)

    k = np.arange(2 * T - 1)[:, None]
    i = np.arange(T)[None, :]
    adm = (i <= k) & (i > k - T)
    if radius is not None:
        adm &= np.abs(2 * i - k) <= radius
    if md is not None:
        adm &= md
    lo, hi = geo.lo[:, None], (geo.lo + geo.width)[:, None]
    # every admissible cell inside its diagonal's hull, and the hull tight
    assert not (adm & ((i < lo) | (i >= hi))).any()
    rows = np.nonzero(geo.width > 0)[0]
    assert adm[rows, geo.lo[rows]].all()
    assert adm[rows, geo.lo[rows] + geo.width[rows] - 1].all()
    assert ((geo.width > 0) == adm.any(axis=1)).all()
    assert geo.W == max(int(geo.width.max()), 1)
    assert geo.G * geo.C >= geo.W
    assert geo.smem_bytes <= SMEM_MAX
    assert geo.warps >= 1 and geo.pairs_per_block >= 1
    if geo.wide:
        assert geo.G == 32 and geo.pairs_per_warp == 1
        assert geo.holes == bool((adm != ((i >= lo) & (i < hi))).any())
        assert geo.regs == (T <= 512)
        if geo.regs:     # fixed positions c * 32 + l in registers
            assert 32 * geo.C >= T and geo.C & (geo.C - 1) == 0
            assert geo.smem_bytes == geo.warps * 2 * T * 4
        else:
            assert geo.smem_bytes == geo.warps * (T + 6 * geo.W) * 4
    else:
        assert geo.W <= 32 and geo.C == 1
        assert geo.G & (geo.G - 1) == 0 and geo.pairs_per_warp == 32 // geo.G
        assert geo.smem_bytes == geo.pairs_per_block * T * 4
        # bit l of diagonal k's word: position lo_k + l is admissible
        words = geo.hull_bits.view(np.uint32).astype(np.uint64)
        lanes = np.arange(32, dtype=np.uint64)[None, :]
        hb = ((words[:, None] >> lanes) & 1).astype(bool)
        pos = geo.lo[:, None] + np.arange(32)[None, :]
        inside = pos < T
        want = np.zeros_like(hb)
        r, c = np.nonzero(inside)
        want[r, c] = adm[r, pos[r, c]]
        assert np.array_equal(hb, want)
    if domain in ("full", "radius204") and T >= 1024:
        assert geo.wide and not geo.holes     # no MAX_T any more
    if domain in ("radius0", "radius6"):
        assert not geo.wide and geo.W == radius + 1


def test_krdtw_narrow_support_packs_eight_pairs_per_warp():
    # |i - j| <= 3: at most 4 positions per diagonal, 4 lanes per pair
    T = 1024
    i = np.arange(T)
    md = t_k4.mask_to_diagonal_major(np.abs(i[:, None] - i[None, :]) <= 3)
    geo = t_k4.krdtw_geometry(T, None,
                              t_k4.pack_diagonal_mask(md, T, "cpu"))
    assert (geo.W, geo.G, geo.pairs_per_warp) == (4, 4, 8)
    assert not geo.wide and geo.smem_bytes <= SMEM_MAX


def test_krdtw_geometry_is_cached_by_content():
    sup = _path_support(40, 3, 1)
    md = t_k4.mask_to_diagonal_major(sup)
    a = t_k4.krdtw_geometry(40, 5, t_k4.pack_diagonal_mask(md, 40, "cpu"))
    b = t_k4.krdtw_geometry(40, 5, t_k4.pack_diagonal_mask(md.copy(), 40,
                                                           "cpu"))
    assert a is b
    assert t_k4.krdtw_geometry(40) is t_k4.krdtw_geometry(40, None, None)


@pytest.mark.parametrize("S", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_spdtw_tile_geometry_fits_the_card(S, d):
    for Tp in sorted({S * 4, S * 8, 256, 2816} - {0}):
        if Tp % S:
            continue
        geo = tile_geometry(S, d, Tp)
        assert geo["smem_bytes"] <= SMEM_MAX
        if S <= 32 and Tp <= 256:
            assert geo["route"] == "thread"
            assert geo["threads"] in (32, 64, 128)
            assert geo["y_in_registers"] == (d <= 3 and S * d <= 64)
            floats = geo["threads"] * (Tp + S) + S * S + \
                (0 if geo["y_in_registers"] else geo["threads"] * d * S)
            assert geo["smem_bytes"] == floats * 4
        if S > 32:
            assert geo["route"] == "lanes" and geo["threads"] == 0
    # the main path's tile: 128 threads per block, y in registers
    main = tile_geometry(16, 1, 128)
    assert (main["route"], main["threads"], main["y_in_registers"]) == \
        ("thread", 128, True)


@pytest.mark.parametrize("W", [1, 3, 53, 255, 257, 409, 1083])
def test_banded_geometry_fits_the_card(W):
    w = (W - 1) // 2
    geo = t_k6.banded_geometry(w)
    assert geo["lanes"] * geo["cells"] >= W
    assert geo["smem_bytes"] <= SMEM_MAX
    assert geo["wide"] == (W > 256)
    assert geo["template"] == ("thread" if W <= 64 else
                               "lanes" if W <= 256 else "wide")
    if geo["template"] == "thread":
        # one thread per pair, the row padded to a power of two
        assert geo["lanes"] == 1 and geo["cells"] < 2 * W
    if geo["wide"]:
        assert geo["lanes"] == 32 and 1 <= geo["pairs_per_block"] <= 4
        assert geo["smem_bytes"] == geo["pairs_per_block"] * 5 * W * 4


@pytest.mark.parametrize("d", [1, 3])
def test_banded_geometry_takes_the_thread_template_up_to_64_cells(d):
    for w in range(0, 513):
        W = 2 * w + 1
        geo = t_k6.banded_geometry(w, 128, d)
        want = "thread" if W <= 64 else "lanes" if W <= 256 else "wide"
        assert geo["template"] == want, w
        assert geo["wide"] == (want == "wide")
        assert geo["lanes"] * geo["cells"] >= W
        assert geo["smem_bytes"] <= SMEM_MAX
        assert geo["reg_floats"] <= REG_FLOATS_MAX
        if want == "thread":
            WP = geo["cells"]
            assert WP >= W and WP // 2 < W and WP & (WP - 1) == 0
            assert geo["lanes"] == 1 and geo["pairs_per_block"] == 128
            assert 1 <= geo["rows"] <= 128
            assert geo["smem_bytes"] == \
                (geo["rows"] + WP - 1) * d * 129 * 4


@pytest.mark.parametrize("T", [1, 5, 24, 128, 129, 1024, 2709])
def test_thread_template_stages_at_least_one_strip_width_of_rows(T):
    """A chunk of staged rows spans at least min(T, WP) strip rows at
    d <= 3 (so no row is staged more than twice), and never more than
    the series has."""
    for w in (0, 3, 13, 26, 31):
        for d in (1, 2, 3):
            geo = t_k6.banded_geometry(w, T, d)
            assert geo["template"] == "thread"
            assert min(T, geo["cells"]) <= geo["rows"] <= T


def test_thread_template_gives_way_where_its_staging_cannot_fit():
    """At many channels one strip row's staging outgrows the card's
    shared memory: "auto" takes the lanes template, a forced "thread"
    raises."""
    assert t_k6.banded_geometry(26, 128, 7)["template"] == "thread"
    geo = t_k6.banded_geometry(26, 128, 8)
    assert geo["template"] == "lanes" and geo["smem_bytes"] <= SMEM_MAX
    with pytest.raises(ValueError, match="thread"):
        t_k6.banded_geometry(26, 128, 8, template="thread")
    with pytest.raises(ValueError, match="thread"):
        t_k6.banded_geometry(32, 128, 1, template="thread")
    with pytest.raises(ValueError, match="lanes"):
        t_k6.banded_geometry(128, 128, 1, template="lanes")
    with pytest.raises(ValueError, match="template"):
        t_k6.banded_geometry(3, 128, 1, template="pairs")


@pytest.mark.parametrize("template", ["thread", "lanes", "wide"])
def test_forced_templates_report_their_own_launch(template):
    geo = t_k6.banded_geometry(26, 128, 1, template=template)
    assert geo["template"] == template
    assert geo["wide"] == (template == "wide")
    assert geo["lanes"] == {"thread": 1, "lanes": 32,
                            "wide": 32}[template]


def test_wide_strip_plain_matches_reference():
    """The plain K6 at a strip of 2w + 1 = 241 > the 32 lanes of a warp,
    against the reference's Pallas kernel in interpret mode."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import dtw_banded as j_k6
    rng = np.random.default_rng(600)
    x = rng.normal(size=(3, 600)).astype(np.float32)
    y = rng.normal(size=(3, 600)).astype(np.float32)
    want = np.asarray(j_k6.banded_dtw(jnp.asarray(x), jnp.asarray(y), 120,
                                      interpret=True))
    got = t_k6.banded_dtw(torch.as_tensor(x), torch.as_tensor(y), 120)
    assert np.array_equal(got.numpy(), want)
