"""ops/cuda_lin.py of the PyTorch port: the plain versions of the four
kernels against the JAX package's Pallas kernels, and the wrappers' device
dispatch.

The JAX kernels run in interpret mode (as tests/test_pallas_lin.py runs
them), on the cases of that file plus a batch of 3 different instances. The
Pallas gj/admm kernels are single-instance, so the JAX side loops over the
batch. Everything compares at float64, where both sides carry out the same
elimination / factorization steps in a different association order
(the plain B1 updates the trailing columns step by step where the Pallas
kernel sums over the finished ones, and the Pallas kernel pads rows with
identity; the plain B2 / B3 eliminate in place, scale the
pivot row by 1/pivot where the Pallas kernels divide the factors by the
pivot, and B3 leaves the columns left of the pivot alone), so they agree to
rounding amplified by the conditioning (cond <= 1e3 here): rtol 1e-9,
atol 1e-11.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g1_locomotion_tpu.ops import pallas_lin
from g1_locomotion_tpu_torch.ops import cuda_lin

RTOL, ATOL = 1e-9, 1e-11


def _random_spd(rng, b, n, cond=1e3):
    """Batch of SPD matrices with eigenvalues in [1, cond] (as test_pallas_lin)."""
    Q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    lams = np.exp(rng.uniform(0.0, np.log(cond), size=(b, n)))
    K = np.einsum("bik,bk,bjk->bij", Q, lams, Q)
    return 0.5 * (K + np.swapaxes(K, -1, -2))


def _spd_ridge(rng, b, m):
    """SPD + ridge systems like the polish Schur complement (as test_pallas_lin)."""
    M = rng.standard_normal((b, m, m))
    return M @ np.swapaxes(M, -1, -2) + 1e-3 * np.eye(m)


def _admm_case(rng, b, n, m):
    P = _random_spd(rng, b, n, cond=1e2)
    A = rng.standard_normal((b, m, n))
    rho = np.abs(rng.standard_normal((b, m))) + 0.5
    sigma = 1e-6
    K = P + sigma * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    return dict(
        Kinv=np.linalg.inv(K), A=A, q=rng.standard_normal((b, n)),
        l=-np.abs(rng.standard_normal((b, m))) - 0.1,
        u=np.abs(rng.standard_normal((b, m))) + 0.1, rho_vec=rho,
        x=rng.standard_normal((b, n)) * 0.1, z=np.zeros((b, m)), y=np.zeros((b, m)),
    )


ADMM_ARGS = ("Kinv", "A", "q", "l", "u", "rho_vec", "x", "z", "y")
SIGMA, ALPHA, NUM = 1e-6, 1.6, 17


def _jax_admm(case, i):
    out = pallas_lin.admm_iterate(
        *(jnp.asarray(case[k][i]) for k in ADMM_ARGS), NUM, SIGMA, ALPHA, interpret=True
    )
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def cases():
    """Inputs and the JAX kernels' interpret-mode results, computed once."""
    rng = np.random.default_rng(11)
    out = {}
    for n, b in ((4, 5), (16, 5), (30, 5), (8, 3)):
        K = _random_spd(rng, b, n)
        out[f"b1_{n}"] = (K, np.asarray(pallas_lin.chol_inverse_base(jnp.asarray(K), interpret=True)))
    for m, b, key in ((37, 1, "b3_1"), (37, 3, "b3_3"), (1, 2, "b3_m1"), (2, 2, "b3_m2")):
        K, rhs = _spd_ridge(rng, b, m), rng.standard_normal((b, m))
        x = np.stack([np.asarray(pallas_lin.gj_solve(jnp.asarray(K[i]), jnp.asarray(rhs[i]),
                                                     interpret=True)) for i in range(b)])
        out[key] = (K, rhs, x)
    for m, b, key in ((21, 1, "b2_1"), (21, 3, "b2_3"), (1, 2, "b2_m1"), (2, 2, "b2_m2")):
        K = _spd_ridge(rng, b, m)
        Ki = np.stack([np.asarray(pallas_lin.gj_inverse(jnp.asarray(K[i]), interpret=True))
                       for i in range(b)])
        out[key] = (K, Ki)
    for b in (1, 3):
        case = _admm_case(rng, b, 13, 21)
        res = [_jax_admm(case, i) for i in range(b)]
        out[f"b4_{b}"] = (case, [np.stack(r) for r in zip(*res)])
    return out


def _close(t, j, rtol=RTOL, atol=ATOL):
    assert tuple(t.shape) == np.shape(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=atol)


@pytest.mark.parametrize("key", ["b1_4", "b1_16", "b1_30", "b1_8"])
def test_chol_inverse_base_matches_pallas(cases, key):
    K, W_jax = cases[key]
    W = cuda_lin.chol_inverse_base(torch.tensor(K))
    _close(W, W_jax)
    # W'W K = I: the plain version is a true inverse factor.
    resid = (W.mT @ W @ torch.tensor(K)).numpy() - np.eye(K.shape[-1])
    assert np.abs(resid).max() < 1e-9


@pytest.mark.parametrize("b", [1, 3])
def test_gj_solve_matches_pallas(cases, b):
    K, rhs, x_jax = cases[f"b3_{b}"]
    x = cuda_lin.gj_solve(torch.tensor(K), torch.tensor(rhs))
    _close(x, x_jax)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(K, rhs[..., None])[..., 0],
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("b", [1, 3])
def test_gj_inverse_matches_pallas(cases, b):
    K, Ki_jax = cases[f"b2_{b}"]
    Ki = cuda_lin.gj_inverse(torch.tensor(K))
    _close(Ki, Ki_jax)
    np.testing.assert_allclose(Ki.numpy(), np.linalg.inv(K), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("m", [1, 2])
def test_gj_smallest_systems_match_pallas(cases, m):
    """m = 1 (one pivot, nothing to eliminate) and m = 2 (one elimination)."""
    K, rhs, x_jax = cases[f"b3_m{m}"]
    _close(cuda_lin.gj_solve(torch.tensor(K), torch.tensor(rhs)), x_jax)
    K, Ki_jax = cases[f"b2_m{m}"]
    _close(cuda_lin.gj_inverse(torch.tensor(K)), Ki_jax)


def test_gj_plain_versions_leave_their_inputs(cases):
    """The plain versions eliminate in place on a copy."""
    K, rhs, _ = cases["b3_3"]
    Kt, bt = torch.tensor(K), torch.tensor(rhs)
    cuda_lin.gj_solve_ref(Kt, bt)
    cuda_lin.gj_inverse_ref(Kt)
    assert np.array_equal(Kt.numpy(), K) and np.array_equal(bt.numpy(), rhs)


@pytest.mark.parametrize("name, dtype, m, expected", [
    # float32 within the register tile: zero padding in registers, no dynamic smem
    ("gj_inverse", torch.float32, 1, ("tile", 0)),
    ("gj_inverse", torch.float32, 120, ("tile", 0)),
    ("gj_inverse", torch.float32, 128, ("tile", 0)),
    ("gj_solve", torch.float32, 200, ("tile", 0)),
    ("gj_solve", torch.float32, 208, ("tile", 0)),
    # B2 beyond its tile, and every float64 system: the in-place array (m, w)
    # and a column (m) in shared memory; B3 at float32 beyond its tile: the
    # cluster tile
    ("gj_inverse", torch.float32, 129, ("smem", 4 * (129 * 129 + 129))),
    ("gj_solve", torch.float32, 209, ("cluster", 0)),
    ("gj_inverse", torch.float64, 120, ("smem", 8 * (120 * 120 + 120))),
    ("gj_solve", torch.float64, 169, ("smem", 8 * (169 * 170 + 169))),
])
def test_gj_plan_picks_tile_or_shared_memory(name, dtype, m, expected):
    assert cuda_lin.gj_plan(name, m, dtype) == expected


# B3 at float32 across its routes' edges: the register tile to m = 208, the
# two-CTA cluster tile from 209 to 240 (the roll-moment cap's 210 among
# them), nothing past 240; B2 keeps its tile and shared memory there.
@pytest.mark.parametrize("name, m, expected", [
    ("gj_solve", 208, ("tile", 0)), ("gj_solve", 209, ("cluster", 0)),
    ("gj_solve", 210, ("cluster", 0)), ("gj_solve", 224, ("cluster", 0)),
    ("gj_solve", 240, ("cluster", 0)), ("gj_solve", 241, None),
    ("gj_inverse", 209, ("smem", 4 * (209 * 209 + 209))),
    ("gj_inverse", 240, ("smem", 4 * (240 * 240 + 240))), ("gj_inverse", 241, None),
])
def test_gj_plan_routes_at_the_float32_edges(name, m, expected):
    if expected is None:
        with pytest.raises(ValueError, match="shared memory"):
            cuda_lin.gj_plan(name, m, torch.float32)
    else:
        assert cuda_lin.gj_plan(name, m, torch.float32) == expected


@pytest.mark.parametrize("name, dtype, m", [
    ("gj_inverse", torch.float32, 241), ("gj_solve", torch.float32, 241),
    ("gj_inverse", torch.float64, 170), ("gj_solve", torch.float64, 170),
    ("gj_solve", torch.float32, 0),
])
def test_gj_plan_refuses_what_no_kernel_takes(name, dtype, m):
    with pytest.raises(ValueError):
        cuda_lin.gj_plan(name, m, dtype)


def test_gj_tile_sizes_match_the_cuda_source():
    """GJ_TILE repeats the tile constants of csrc/lin_kernels.cu: rows are
    warps * rows per thread, columns 32 * chunks per thread."""
    src = cuda_lin.SOURCE.read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int kGj(\w+) = (\d+);", src)}
    for name, kind in (("gj_inverse", "Inverse"), ("gj_solve", "Solve")):
        assert cuda_lin.GJ_TILE[name] == (const[kind + "W"] * const[kind + "R"],
                                          32 * const[kind + "C"])
        assert 32 % const[kind + "W"] == 0 and const[kind + "W"] % const["Bufs"] == 0
    assert int(re.search(r"kMaxSmem = (\d+);", src).group(1)) == cuda_lin.MAX_SMEM_BYTES


def test_cluster_and_wide_tiles_match_the_cuda_source():
    """GJ_CLUSTER and ADMM_TILE_WIDE repeat the constants of
    csrc/lin_kernels.cu: the cluster tile's rows are CTAs * warps * rows per
    thread, its columns 32 * chunks per thread, and every m that gj_plan
    sends it fits (b included); the wide B4 tile has kAdmmRAWide rows of A a
    thread, within the 16 row states a warp keeps. The route codes are the
    ones launch_gj and launch_admm take."""
    src = cuda_lin.SOURCE.read_text()
    gj = {k: int(v) for k, v in re.findall(r"constexpr int kGj(\w+) = (\d+);", src)}
    assert cuda_lin.GJ_CLUSTER == (gj["ClusterCtas"] * gj["ClusterW"] * gj["ClusterR"],
                                   32 * gj["ClusterC"])
    assert re.search(r"__cluster_dims__\(kGjClusterCtas, 1, 1\)", src)
    assert 32 % gj["ClusterW"] == 0 and gj["ClusterW"] % gj["Bufs"] == 0
    rows, cols = cuda_lin.GJ_CLUSTER
    assert cuda_lin.GJ_TILE["gj_solve"][0] < cuda_lin.GJ_CLUSTER_MAX_M <= rows
    assert cuda_lin.GJ_CLUSTER_MAX_M + 1 <= cols
    admm = {k: int(v) for k, v in re.findall(r"constexpr int kAdmm(\w+) = (\d+);", src)}
    assert cuda_lin.ADMM_TILE_WIDE == (admm["W"] * admm["RAWide"], 32 * admm["C"])
    assert admm["RA"] < admm["RAWide"] <= 16
    enum = re.search(r"enum GjRoute \{ kGjSmem = (\d+), kGjTile = (\d+), kGjCluster = (\d+) \};",
                     src)
    assert tuple(map(int, enum.groups())) == tuple(
        cuda_lin.GJ_ROUTES[k] for k in ("smem", "tile", "cluster"))
    assert cuda_lin.ADMM_ROUTES == {"smem": 0, "tile13": admm["RA"], "tile14": admm["RAWide"]}


@pytest.mark.parametrize("n, m, dtype, expected", [
    # float32 within the register tile: K^-1 and A in registers, no dynamic smem
    (120, 200, torch.float32, ("tile13", 0)),
    (128, 208, torch.float32, ("tile13", 0)),
    (1, 1, torch.float32, ("tile13", 0)),
    # beyond the tiles, and every float64 QP: K^-1, A and eleven vectors in
    # shared memory; float32 m <= 224: the tile with 14 rows of A a thread
    (129, 200, torch.float32, ("smem", 4 * (129 * 129 + 200 * 129 + 4 * 129 + 7 * 200))),
    (120, 209, torch.float32, ("tile14", 0)),
    (13, 21, torch.float64, ("smem", 8 * (13 * 13 + 21 * 13 + 4 * 13 + 7 * 21))),
])
def test_admm_plan_picks_tile_or_shared_memory(n, m, dtype, expected):
    assert cuda_lin.admm_plan(n, m, dtype) == expected


# B4 at float32 across its routes' edges: 13 rows of A a thread to m = 208,
# 14 to m = 224 (the roll-moment cap's 210 among them), then shared memory;
# n > 128 takes shared memory at any m.
@pytest.mark.parametrize("n, m, expected", [
    (120, 208, "tile13"), (120, 209, "tile14"), (120, 210, "tile14"), (128, 224, "tile14"),
    (128, 225, "smem"), (129, 210, "smem"),
])
def test_admm_plan_routes_at_the_float32_edges(n, m, expected):
    route, nbytes = cuda_lin.admm_plan(n, m, torch.float32)
    assert route == expected
    assert nbytes == (0 if expected != "smem" else 4 * (n * n + m * n + 4 * n + 7 * m))


@pytest.mark.parametrize("n, m, dtype", [
    (120, 200, torch.float64),  # the MPC's QP at float64: 322 KB of operands
    (200, 240, torch.float32), (0, 5, torch.float32), (5, 0, torch.float32),
])
def test_admm_plan_refuses_what_no_kernel_takes(n, m, dtype):
    with pytest.raises(ValueError):
        cuda_lin.admm_plan(n, m, dtype)


def test_admm_tile_sizes_match_the_cuda_source():
    """ADMM_TILE repeats the tile constants of csrc/lin_kernels.cu: A's rows
    are warps * rows per thread, the columns 32 * chunks per thread, and
    K^-1's rows cover the columns."""
    src = cuda_lin.SOURCE.read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int kAdmm(\w+) = (\d+);", src)}
    assert cuda_lin.ADMM_TILE == (const["W"] * const["RA"], 32 * const["C"])
    assert const["W"] * const["RK"] >= 32 * const["C"]
    assert const["RA"] <= 16 and const["PartLd"] >= const["W"] and const["PartLd"] % 4 == 0


@pytest.mark.parametrize("n", [1, 7, 30])
def test_chol_inverse_base_writes_into_a_strided_view(n):
    """With ``out`` the result lands in a block of a larger matrix, zeros above
    the diagonal included, and nothing around the block is touched; K may be a
    block of a larger matrix too."""
    rng = np.random.default_rng(n)
    K = torch.tensor(_random_spd(rng, 3, n))
    parent = torch.full((3, 2 * n + 1, 2 * n + 2), 5.0, dtype=torch.float64)
    block = (slice(None), slice(n, 2 * n), slice(1, n + 1))
    parent[block] = K
    target = torch.full((3, 2 * n + 1, 2 * n + 2), 7.0, dtype=torch.float64)
    out = cuda_lin.chol_inverse_base(parent[block], out=target[block])
    assert out.data_ptr() == target[block].data_ptr()
    assert torch.equal(target[block], cuda_lin.chol_inverse_base(K))
    assert torch.all(torch.triu(target[block], 1) == 0)
    assert int((target == 7.0).sum()) == target.numel() - K.numel()
    with pytest.raises(ValueError):
        cuda_lin.chol_inverse_base(K, out=torch.empty((3, n, n + 1), dtype=torch.float64))
    with pytest.raises(ValueError):
        cuda_lin.chol_inverse_base(K, out=torch.empty((3, n, n), dtype=torch.float32))


@pytest.mark.parametrize("b", [1, 3])
def test_admm_iterate_matches_pallas(cases, b):
    case, (x_j, z_j, y_j) = cases[f"b4_{b}"]
    x, z, y = cuda_lin.admm_iterate(*(torch.tensor(case[k]) for k in ADMM_ARGS),
                                    NUM, SIGMA, ALPHA)
    _close(x, x_j)
    _close(z, z_j)
    _close(y, y_j)


def test_cpu_calls_never_reach_the_loader(cases, monkeypatch):
    """A CPU tensor takes the plain version without building or loading the
    CUDA library (this machine may have no nvcc and no card)."""

    def refuse(*_a, **_k):
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(cuda_lin, "_lib", refuse)
    monkeypatch.setattr(cuda_lin, "build", refuse)
    before = cuda_lin.launch_counts()
    K, _ = cases["b1_8"]
    cuda_lin.chol_inverse_base(torch.tensor(K))
    K, rhs, _ = cases["b3_3"]
    cuda_lin.gj_solve(torch.tensor(K), torch.tensor(rhs))
    cuda_lin.gj_inverse(torch.tensor(K))
    case, _ = cases["b4_3"]
    cuda_lin.admm_iterate(*(torch.tensor(case[k]) for k in ADMM_ARGS), NUM, SIGMA, ALPHA)
    assert cuda_lin.launch_counts() == before  # plain versions count no launch


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """A tensor that is not on the CPU must launch the kernel or raise; here
    a meta tensor is refused by the checks before any launch."""
    monkeypatch.setattr(cuda_lin, "_lib", lambda: pytest.fail("no launch expected"))
    K = torch.empty((2, 8, 8), dtype=torch.float32, device="meta")
    b = torch.empty((2, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        cuda_lin.chol_inverse_base(K)
    with pytest.raises(ValueError):
        cuda_lin.gj_inverse(K)
    with pytest.raises(ValueError):
        cuda_lin.gj_solve(K, b)
    with pytest.raises(ValueError):
        cuda_lin.admm_iterate(K, K, b, b, b, b, b, b, b, 3, SIGMA, ALPHA)
