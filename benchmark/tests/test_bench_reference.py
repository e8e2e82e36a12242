"""The plain reference against the port at float64 on the CPU, through the
drivers' own records and checks: at float64 the two agree to rounding."""

import pytest
import torch

from benchmark.harness import manifest

# At float64 the port's plain path and the reference differ only in how the
# factorizations round (the port's column Cholesky and Gauss-Jordan against
# torch.linalg). That is ~1e-10 on forces, except where the WBID polish's
# acceptance of a round flips on it and moves tau by 2e-2 to 6e-2 N m (as
# the JAX package's own eager and jitted ticks do): tau within 0.1 N m, and
# the golden walk's other tolerances (tests/test_golden.py: forces 0.5 N,
# CoM 1e-4 m).
TOL = {"tau_Nm": 0.1, "force_N": 0.5, "mpc_u0_N": 0.5, "mpc_plan_N": 0.5,
       "next_q": 1e-4, "next_v": 1e-2, "clock_s": 1e-12, "body_x": 1e-6, "feet_m": 1e-9,
       "landing_m": 1e-9, "com_start_m": 1e-9, "min_z_m": 1e-4, "tau_max_Nm": 0.1,
       "state": 0.5}


def run_f64(cell_name, batch, units, **config):
    cell = manifest.resolve(cell_name)
    cfg = dict(cell.config, batch=batch, dtype="float64", **config)
    driver = cell.driver.DRIVER(cfg, cell.traffic, 2**33 + 5, "cpu")
    driver.setup(warm=False)
    for _ in range(units):
        driver.step()
    return driver.check("cpu")


@pytest.mark.parametrize("cell_name,batch,units,config", [
    ("serving_b1", 1, 3, {"check_units": {"tick": 2, "mpc": 1}}),
    ("srbd_gait_4096", 4, 5, {"check_units": {"period": 4}}),
    ("sweep_4096", 2, 1, {"check_units": {"period": 1}}),
])
def test_reference_agrees_with_port_at_f64(cell_name, batch, units, config):
    torch.set_num_threads(2)
    gaps = run_f64(cell_name, batch, units, **config)
    assert gaps.rows, "nothing was checked"
    for name in gaps.rows:
        assert gaps.value(f"{name}.max") <= TOL[name], (name, gaps.value(f"{name}.max"))
