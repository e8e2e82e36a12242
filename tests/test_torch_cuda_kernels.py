"""The CUDA kernels of ops/cuda_lin.py against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports torch and numpy only (the machine with the card has no JAX), so it
runs there without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py -q

Tolerances, kernel vs plain version on the same inputs on the card:
float32 2e-4 (tests/test_pallas_lin.py's kernel tolerance: f32 rounding
amplified by cond <= 1e3 over a few hundred dependent steps), float64 1e-9.
"""

import numpy as np
import pytest
import torch

from g1_locomotion_tpu_torch.ops import cuda_lin

TOL = {torch.float32: 2e-4, torch.float64: 1e-9}
SIGMA, ALPHA, NUM = 1e-6, 1.6, 17
ADMM_ARGS = ("Kinv", "A", "q", "l", "u", "rho_vec", "x", "z", "y")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_spd(seed, b, n, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    lams = np.exp(rng.uniform(0.0, np.log(cond), size=(b, n)))
    K = np.einsum("bik,bk,bjk->bij", Q, lams, Q)
    return 0.5 * (K + np.swapaxes(K, -1, -2))


def _admm_case(seed, b, n, m):
    rng = np.random.default_rng(seed)
    P = _random_spd(seed + 1, b, n, cond=1e2)
    A = rng.standard_normal((b, m, n))
    rho = np.abs(rng.standard_normal((b, m))) + 0.5
    K = P + SIGMA * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    return dict(
        Kinv=np.linalg.inv(K), A=A, q=rng.standard_normal((b, n)),
        l=-np.abs(rng.standard_normal((b, m))) - 0.1,
        u=np.abs(rng.standard_normal((b, m))) + 0.1, rho_vec=rho,
        x=rng.standard_normal((b, n)) * 0.1, z=np.zeros((b, m)), y=np.zeros((b, m)),
    )


def _counted(name, fn):
    """Run fn() and assert that it launched kernel `name` exactly once."""
    before = cuda_lin.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert cuda_lin.launch_counts()[name] == before + 1
    return out


# Every block size the kernel is built for; dense, and as the recursion of
# ops/lin.py calls it: K a block of a larger matrix, W written into a block of
# a larger W, both off the origin. B = 137 is more matrices than fit a block.
@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["dense", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", list(range(1, 33)))
def test_chol_inverse_base(cuda, dtype, n, layout):
    K = torch.tensor(_random_spd(n, 137, n), dtype=dtype, device=cuda)
    ref = cuda_lin.chol_inverse_base_ref(K)
    if layout == "dense":
        W = _counted("chol_inverse_base", lambda: cuda_lin.chol_inverse_base(K))
    else:
        big, off = 2 * n + 3, n + 1
        parent = torch.full((137, big, big), 5.0, dtype=dtype, device=cuda)
        block = (slice(None), slice(off, off + n), slice(off - 1, off - 1 + n))
        parent[block] = K
        target = torch.full((137, big + 2, big + 1), 7.0, dtype=dtype, device=cuda)
        W = _counted("chol_inverse_base",
                     lambda: cuda_lin.chol_inverse_base(parent[block], out=target[block]))
        assert W.data_ptr() == target[block].data_ptr()
        assert int((target == 7.0).sum()) == target.numel() - K.numel()  # only its block
        assert torch.equal(parent[block], K)
    torch.testing.assert_close(W, ref, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.all(torch.triu(W, 1) == 0)


# float32 up to m = 128 (B2) / 208 (B3) runs the register-tile kernel, all
# else the shared-memory kernel; B = 300 is more blocks than the card has SMs.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype, m, b", [
    (torch.float32, 1, 3), (torch.float32, 21, 3), (torch.float32, 120, 3),
    (torch.float32, 128, 3), (torch.float32, 150, 3), (torch.float32, 120, 300),
    (torch.float64, 1, 3), (torch.float64, 21, 3), (torch.float64, 120, 3),
    (torch.float64, 169, 2),
])
def test_gj_inverse(cuda, dtype, m, b):
    K = torch.tensor(_random_spd(m, b, m, cond=1e2), dtype=dtype, device=cuda)
    Ki = _counted("gj_inverse", lambda: cuda_lin.gj_inverse(K))
    torch.testing.assert_close(Ki, cuda_lin.gj_inverse_ref(K), rtol=TOL[dtype], atol=TOL[dtype])


# B3 at float32 past the tile (209 <= m <= 240) runs the two-CTA cluster
# tile: its edges and the roll-moment cap's 210, at B = 1, 2 and 150 (more
# clusters than the card has pairs of SMs).
@pytest.mark.gpu
@pytest.mark.parametrize("dtype, m, b", [
    (torch.float32, 1, 3), (torch.float32, 37, 3), (torch.float32, 160, 3),
    (torch.float32, 200, 3), (torch.float32, 208, 3), (torch.float32, 230, 3),
    (torch.float32, 200, 300),
    (torch.float64, 1, 3), (torch.float64, 37, 3), (torch.float64, 160, 3),
    (torch.float64, 169, 2),
    *[(torch.float32, m, b) for m in (209, 210, 224, 240) for b in (1, 2, 150)],
])
def test_gj_solve(cuda, dtype, m, b):
    K = torch.tensor(_random_spd(m, b, m, cond=1e2), dtype=dtype, device=cuda)
    rhs = torch.tensor(np.random.default_rng(m).standard_normal((b, m)), dtype=dtype,
                       device=cuda)
    x = _counted("gj_solve", lambda: cuda_lin.gj_solve(K, rhs))
    torch.testing.assert_close(x, cuda_lin.gj_solve_ref(K, rhs), rtol=TOL[dtype],
                               atol=TOL[dtype])


# The cluster tile does the register tile's arithmetic in the tile's order:
# where both take a system (m <= 208, the cluster's route launched directly),
# their results agree bit for bit; past the tile it matches its plain
# version (test_gj_solve).
@pytest.mark.gpu
@pytest.mark.parametrize("m, b", [(1, 2), (37, 3), (200, 2), (208, 150)])
def test_gj_cluster_tile_equals_the_register_tile(cuda, m, b):
    K = torch.tensor(_random_spd(m, b, m, cond=1e2), dtype=torch.float32, device=cuda)
    rhs = torch.tensor(np.random.default_rng(m).standard_normal((b, m)), dtype=torch.float32,
                       device=cuda)
    assert cuda_lin.gj_plan("gj_solve", m, torch.float32) == ("tile", 0)
    x_tile = cuda_lin.gj_solve(K, rhs)
    x_cluster = torch.empty_like(rhs)
    cuda_lin._launch("lin_gj_solve", K.dtype, cuda_lin._ptr(K), cuda_lin._ptr(rhs),
                     cuda_lin._ptr(x_cluster), b, m, cuda_lin.GJ_ROUTES["cluster"],
                     cuda_lin._stream(K))
    torch.cuda.synchronize()
    assert torch.equal(x_cluster, x_tile)


# float32 up to n = 128, m = 208 runs the register-tile kernel with 13 rows
# of A a thread (the MPC's (120, 200), the tile's full size, a ragged small
# QP), up to m = 224 the one with 14 (the roll-moment cap's (120, 210), its
# edges), all else the shared-memory kernel; B = 150 is more blocks than the
# card has SMs.
@pytest.mark.gpu
@pytest.mark.parametrize("num", [0, 1, 10, NUM])
@pytest.mark.parametrize("dtype, n, m, b", [
    (torch.float32, 13, 21, 4), (torch.float64, 13, 21, 4), (torch.float32, 120, 200, 2),
    (torch.float32, 120, 200, 1), (torch.float32, 128, 208, 2), (torch.float32, 1, 1, 3),
    (torch.float32, 130, 40, 2), (torch.float32, 40, 210, 2), (torch.float32, 120, 200, 150),
    *[(torch.float32, n, m, b) for n, m in ((120, 209), (120, 210), (128, 224))
      for b in (1, 2, 150)],
])
def test_admm_iterate(cuda, dtype, n, m, b, num):
    args = _admm_tensors(cuda, dtype, n, m, b)
    out = _counted("admm_iterate", lambda: cuda_lin.admm_iterate(*args, num, SIGMA, ALPHA))
    ref = cuda_lin.admm_iterate_ref(*args, num, SIGMA, ALPHA)
    for o, r in zip(out, ref):
        scale = float(r.abs().max())
        torch.testing.assert_close(o, r, rtol=TOL[dtype], atol=TOL[dtype] * max(scale, 1.0))


@pytest.mark.gpu
def test_admm_iterate_refuses_float64_at_mpc_size(cuda):
    """K^-1 and A of the MPC QP need 322 KB of shared memory at float64, more
    than a Hopper block has: the wrapper refuses before launching."""
    args = _admm_tensors(cuda, torch.float64, 120, 200, 1)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_lin.admm_iterate(*args, NUM, SIGMA, ALPHA)


def _admm_tensors(device, dtype, n, m, b):
    case = _admm_case(n + m, b, n, m)
    return [torch.tensor(case[k], dtype=dtype, device=device) for k in ADMM_ARGS]


@pytest.mark.gpu
def test_wrappers_refuse_bad_input(cuda):
    K = torch.eye(40, device=cuda).expand(2, 40, 40)
    with pytest.raises(ValueError):
        cuda_lin.chol_inverse_base(K.contiguous())  # n > 32
    with pytest.raises(ValueError):
        cuda_lin.chol_inverse_base(K[:, :8, :8].mT)  # column stride is not 1
    with pytest.raises(ValueError):
        cuda_lin.chol_inverse_base(K[:, :8, :8].contiguous(), out=K[:, :8, :8])  # out overlaps
    with pytest.raises(ValueError):
        cuda_lin.chol_inverse_base(K[:, :8, :8].contiguous(),
                                   out=torch.empty((2, 8, 9), device=cuda))  # out's shape
    with pytest.raises(ValueError):
        cuda_lin.gj_inverse(K)  # not contiguous
    with pytest.raises(ValueError):
        cuda_lin.gj_inverse(K.contiguous().half())  # dtype
    with pytest.raises(ValueError):
        cuda_lin.gj_inverse(torch.eye(200, dtype=torch.float64, device=cuda)[None])  # smem
    with pytest.raises(ValueError):
        cuda_lin.gj_solve(torch.eye(170, dtype=torch.float64, device=cuda)[None],
                          torch.ones((1, 170), dtype=torch.float64, device=cuda))  # smem
    with pytest.raises(ValueError):
        cuda_lin.gj_solve(K.contiguous(), torch.ones((2, 40)))  # b on the CPU


@pytest.mark.gpu
def test_slice_float64_on_card_matches_cpu(cuda):
    """The throughput slice at float64: kernel B1 on the card against the
    plain path on the CPU, u0 to 1e-6 N (the CPU test tolerance vs JAX)."""
    from g1_locomotion_tpu_torch.models import srbd
    from g1_locomotion_tpu_torch.mpc import solver as mpc
    from g1_locomotion_tpu_torch.ops.qp import QPConfig

    cfg = mpc.MPCConfig(horizon=10, qp=QPConfig(iters=20, scaling_iters=0, rho=1.0,
                                                rho_segments=2, polish_rounds=2))
    N, B = 10, 6
    x0 = torch.zeros(13, dtype=torch.float64)
    x0[3:6] = torch.tensor([0.0527, 0.0, 0.598])
    x0[12] = srbd.GRAVITY
    feet = torch.tensor([[-0.05, 0.12, 0.0], [0.12, 0.12, 0.0],
                         [-0.05, -0.12, 0.0], [0.12, -0.12, 0.0]], dtype=torch.float64)
    contact = torch.ones((B, N, 4), dtype=torch.float64)
    contact[1::3, :, :2] = 0.0
    contact[2::3, :, 2:] = 0.0
    x0s = x0.repeat(B, 1)
    x0s[:, 4] += torch.linspace(-0.03, 0.03, B, dtype=torch.float64)
    args = [x0s, x0.repeat(N, 1), contact, feet.repeat(N, 1, 1), x0[3:6].repeat(N, 1)]

    def solve(device):
        w = mpc.default_weights(device=device, dtype=torch.float64)
        p = srbd.default_params(device=device, dtype=torch.float64)
        return mpc.solve(cfg, w, p, *(a.to(device) for a in args))

    before = cuda_lin.launch_counts()["chol_inverse_base"]
    on_card = solve(cuda)
    assert cuda_lin.launch_counts()["chol_inverse_base"] > before
    on_cpu = solve(torch.device("cpu"))
    torch.testing.assert_close(on_card.u0.cpu(), on_cpu.u0, rtol=0, atol=1e-6)


# The WBID tick's shapes (nx = 41 variables, m = 80 rows): B1 on the blocks
# the recursion of ops/lin.py hands it at B = 2048 (41 -> 20 | 21, 80 -> 40 ->
# 20), K and W both views of their parents; B2 on K and Hr (41); B3 on the
# polish system (80); B4 at 41 x 80 for the serving tick's 25 iterations.
# The variants' ticks: 29-DoF nx = 47 -> 23 | 24, m = 92 -> 46 -> 23;
# with-hand nx = 61 -> 30 | 31 -> 15 | 16, m = 120 -> 60 -> 30.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("parent, n, off", [(41, 20, 0), (41, 21, 20), (80, 20, 0),
                                            (80, 20, 20), (80, 20, 60), (47, 23, 0),
                                            (47, 24, 23), (92, 23, 69), (61, 30, 0),
                                            (61, 15, 30), (61, 16, 45), (120, 30, 90)])
def test_chol_inverse_base_at_wbid_blocks(cuda, dtype, parent, n, off):
    K = torch.tensor(_random_spd(parent + off, 2048, parent), dtype=dtype, device=cuda)
    W = torch.zeros_like(K)
    block = (slice(None), slice(off, off + n), slice(off, off + n))
    out = _counted("chol_inverse_base", lambda: cuda_lin.chol_inverse_base(K[block],
                                                                           out=W[block]))
    assert out.data_ptr() == W[block].data_ptr()
    torch.testing.assert_close(out, cuda_lin.chol_inverse_base_ref(K[block].contiguous()),
                               rtol=TOL[dtype], atol=TOL[dtype])
    W[block] = 0
    assert not W.any()  # nothing outside its block


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gj_at_wbid_shapes(cuda, dtype):
    K = torch.tensor(_random_spd(41, 1, 41, cond=1e2), dtype=dtype, device=cuda)
    Ki = _counted("gj_inverse", lambda: cuda_lin.gj_inverse(K))
    torch.testing.assert_close(Ki, cuda_lin.gj_inverse_ref(K), rtol=TOL[dtype], atol=TOL[dtype])
    S = torch.tensor(_random_spd(80, 1, 80, cond=1e2), dtype=dtype, device=cuda)
    rhs = torch.tensor(np.random.default_rng(80).standard_normal((1, 80)), dtype=dtype,
                       device=cuda)
    x = _counted("gj_solve", lambda: cuda_lin.gj_solve(S, rhs))
    torch.testing.assert_close(x, cuda_lin.gj_solve_ref(S, rhs), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("num", [0, 25])
def test_admm_iterate_at_wbid_shape(cuda, dtype, num):
    args = _admm_tensors(cuda, dtype, 41, 80, 1)
    out = _counted("admm_iterate", lambda: cuda_lin.admm_iterate(*args, num, SIGMA, ALPHA))
    ref = cuda_lin.admm_iterate_ref(*args, num, SIGMA, ALPHA)
    for o, r in zip(out, ref):
        scale = float(r.abs().max())
        torch.testing.assert_close(o, r, rtol=TOL[dtype], atol=TOL[dtype] * max(scale, 1.0))


@pytest.mark.gpu
def test_wbid_tick_float64_on_card_matches_cpu(cuda):
    """The batched WBID tick (default WBIDConfig) at float64: kernel B1 on the
    card against the plain path on the CPU, forces and torques to 1e-6 (the
    CPU test tolerance vs JAX), 18 B1 launches."""
    from g1_locomotion_tpu_torch.engine.state import q_init_standing
    from g1_locomotion_tpu_torch.models import robot as rb
    from g1_locomotion_tpu_torch.wbid import solver as ws
    from g1_locomotion_tpu_torch.wbid.stack import StackIndices
    from g1_locomotion_tpu_torch.wbid.tasks import WBIDReferences, default_gains

    def tick(device):
        model = rb.load_robot("g1_23dof", device=device, dtype=torch.float64)
        idx = StackIndices.from_model(model)
        q = q_init_standing(model, 3)
        X = rb.fk(model, q)
        feet = [rb.frame_pose(model, X, f) for f in idx.feet]
        p, R = torch.stack([P.p for P in feet], 1), torch.stack([P.R for P in feet], 1)
        active = torch.tensor([[1.0, 1.0], [0.0, 1.0], [1.0, 0.0]], dtype=torch.float64,
                              device=device)
        on = active.repeat_interleave(2, dim=1)
        fz = float(model.total_mass) * 9.80665 * on / on.sum(dim=1, keepdim=True)
        z = q.new_zeros((3, 3))
        refs = WBIDReferences(
            com_pos=rb.com_position(model, X), com_vel=z, com_acc=z, base_R=X.R[:, 0],
            base_angvel=z, base_angacc=z, posture_q=q[:, 7:], contact_pos=p, contact_R=R,
            swing_pos=p + 0.02 * (1 - active)[..., None], swing_vel=q.new_zeros((3, 2, 3)),
            swing_acc=q.new_zeros((3, 2, 3)), swing_R=R,
            f_des=torch.stack([torch.zeros_like(fz), torch.zeros_like(fz), fz], -1),
            contact_active=active, angmom_L=z, angmom_Ldot=z)
        gains = default_gains(device=device, dtype=torch.float64)
        return ws.solve(model, idx, ws.WBIDConfig(), gains, q, q.new_zeros((3, model.nv)), refs)

    before = cuda_lin.launch_counts()["chol_inverse_base"]
    on_card = tick(cuda)
    torch.cuda.synchronize()
    assert cuda_lin.launch_counts()["chol_inverse_base"] == before + 18
    on_cpu = tick(torch.device("cpu"))
    torch.testing.assert_close(on_card.forces.cpu(), on_cpu.forces, rtol=0, atol=1e-6)
    torch.testing.assert_close(on_card.tau.cpu(), on_cpu.tau, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_srbd_loop_float64_on_card_matches_cpu(cuda):
    """The batched SRBD loop (mpc/srbd_loop.py, MPCConfig(): kernel B1 at n =
    30 / 25) at float64, B = 16, 10 periods with a lateral kick per instance
    at period 5: the card (kernel B1) against the CPU (its plain version),
    states and forces to 1e-6 (the CPU test tolerance vs JAX), 28 B1
    launches a period."""
    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.mpc import srbd_loop as sl
    from g1_locomotion_tpu_torch.mpc.solver import MPCConfig

    B, periods = 16, 10
    kicks = np.zeros((B, periods, 3))
    kicks[:, 5, 1] = np.random.default_rng(0).uniform(0.0, 0.15, B)

    def loop(device):
        cfg = MPCConfig()
        state = sl.init_loop_state(cfg, 0.598, batch=B, device=device, dtype=torch.float64)
        params = eng.walking_scenario(device=device, dtype=torch.float64)
        return sl.SRBDLoop(cfg).rollout(state, params, periods,
                                        torch.tensor(kicks, device=device))

    before = cuda_lin.launch_counts()["chol_inverse_base"]
    _, on_card = loop(cuda)
    torch.cuda.synchronize()
    assert cuda_lin.launch_counts()["chol_inverse_base"] == before + 28 * periods
    _, on_cpu = loop(torch.device("cpu"))
    for name in ("x", "u0", "landing", "pri_res"):
        torch.testing.assert_close(getattr(on_card, name).cpu(), getattr(on_cpu, name),
                                   rtol=0, atol=1e-6)
    assert torch.equal(on_card.contact.cpu(), on_cpu.contact)


@pytest.mark.gpu
@pytest.mark.parametrize("polish_kernel", [False, True])
def test_srbd_loop_period_makes_no_host_sync(cuda, polish_kernel):
    """One SRBD-loop period (after a warm one) with the card's sync check set
    to raise: no operation makes the host wait for the card
    (tools/period_sync_check.py's method), in MPCConfig() at B = 64 (B1) and
    on the serving chain at B = 1 (B2-B4)."""
    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.mpc import srbd_loop as sl
    from g1_locomotion_tpu_torch.mpc.solver import MPCConfig

    cfg = MPCConfig()
    cfg = cfg._replace(qp=cfg.qp._replace(polish_kernel=polish_kernel))
    B = 1 if polish_kernel else 64
    loop = sl.SRBDLoop(cfg)
    params = eng.walking_scenario(device=cuda, dtype=torch.float32)
    kick = torch.tensor([0.0, 0.1, 0.0], device=cuda).expand(B, 3)
    state, _ = loop.period(sl.init_loop_state(cfg, 0.598, batch=B, device=cuda,
                                              dtype=torch.float32), params, kick)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop.period(state, params, kick)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
def test_serving_solve_with_roll_moment_cap_on_card(cuda):
    """A serving MPC solve (polish_kernel) with MPCConfig.roll_moment_max at
    float32, B = 1: m = 210 rows, so B3 runs its cluster tile and B4 its tile
    with 14 rows of A a thread (cuda_lin.gj_plan / admm_plan); B2 3, B3 2, B4
    2 launches; u0 within 0.5 N of the CPU's plain path (chip_smoke.py's
    DU0_MAX_N)."""
    from g1_locomotion_tpu_torch.models import srbd
    from g1_locomotion_tpu_torch.mpc import solver as mpc
    from g1_locomotion_tpu_torch.ops.qp import QPConfig

    assert cuda_lin.gj_plan("gj_solve", 210, torch.float32) == ("cluster", 0)
    assert cuda_lin.admm_plan(120, 210, torch.float32) == ("tile14", 0)
    cfg = mpc.MPCConfig(horizon=10, roll_moment_max=20.0, qp=QPConfig(
        iters=20, scaling_iters=0, rho=1.0, rho_segments=2, polish_rounds=2,
        polish_kernel=True))
    com = [0.0527, 0.01, 0.598]
    x0 = torch.zeros((1, 13))
    x0[0, 3:6] = torch.tensor(com)
    x0[0, 12] = srbd.GRAVITY
    contact = torch.ones((1, 10, 4))
    contact[:, :, :2] = 0.0  # the left foot swings
    feet = torch.tensor([[-0.05, 0.12, 0.0], [0.12, 0.12, 0.0], [-0.05, -0.12, 0.0],
                         [0.12, -0.12, 0.0]])

    def solve(device):
        t = lambda x: x.to(device)  # noqa: E731
        return mpc.solve(cfg, mpc.default_weights(device=device), srbd.default_params(
            device=device), t(x0), t(x0[:, None].expand(1, 10, 13)), t(contact),
            t(feet.expand(1, 10, 4, 3)), t(torch.tensor(com).expand(1, 10, 3)))

    before, routes = cuda_lin.launch_counts(), cuda_lin.route_counts()
    on_card = solve(cuda)
    torch.cuda.synchronize()
    after = cuda_lin.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "chol_inverse_base": 0, "gj_inverse": 3, "gj_solve": 2, "admm_iterate": 2}
    for name, route in (("gj_solve", "cluster"), ("admm_iterate", "tile14")):
        assert cuda_lin.route_counts()[name].get(route, 0) - routes[name].get(route, 0) == 2
    on_cpu = solve(torch.device("cpu"))
    assert float((on_card.u0.cpu() - on_cpu.u0).abs().max()) <= 0.5


@pytest.mark.gpu
def test_bridge_controller_float64_on_card_matches_cpu(cuda):
    """The MuJoCo bridge's controller (engine/mujoco_bridge.BridgeController)
    at float64 on the recorded trace's first two ticks: the card (kernel B1
    <double, n>, 28 + 2 x 18 launches) against the CPU, tau within 5e-2 N m
    (the golden's tolerance: the WBID polish's acceptance decision is taken
    at the rounding level)."""
    from pathlib import Path

    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.engine.mujoco_bridge import BridgeController
    from g1_locomotion_tpu_torch.models.robot import load_robot

    trace = np.load(Path(__file__).parent / "torch_mujoco_trace.npz")

    def run(device):
        model = load_robot("g1_23dof", device=device, dtype=torch.float64)
        ctrl = BridgeController(model, params=eng.mujoco_standing_scenario(
            device=device, dtype=torch.float64))
        ctrl.reset(trace["qpos"][0], trace["qvel"][0])
        return np.stack([ctrl.step(trace["qpos"][t], trace["qvel"][t])[0] for t in range(2)])

    before = cuda_lin.launch_counts()["chol_inverse_base"]
    on_card = run(cuda)
    assert cuda_lin.launch_counts()["chol_inverse_base"] == before + 28 + 2 * 18
    assert np.abs(on_card - run(torch.device("cpu"))).max() <= 5e-2
