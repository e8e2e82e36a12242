"""The plain reference: plain PyTorch that imports nothing of the program.

``g1ref`` is a frozen copy of the port's modules on its plain path (the
control period, the WBID tick, the SRBD MPC and its closed loop), with the
four kernels replaced by plain PyTorch (``g1ref/ops/plain_lin.py``) and the
23-DoF G1's description copied beside it. ``bridge.py`` is the bridge's
controller step on top of it.
"""
