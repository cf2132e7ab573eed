"""Program drivers: each builds one entry of the program under test
(``temporalalignnet_torch``) for a cell, drives its first steps, dispatches
one unit of the window at a time and, once the window has closed, checks
what the timed path produced against the plain reference.

A driver module defines ``Driver(cfg, workload, seed, device)`` with
``setup()``, ``dispatch(i)``, ``sync()``, ``failed()``, ``release()``,
``check() -> {name: number}``, ``flops_per_unit()`` and
``kernel_bounds(peaks) -> {family: seconds per unit}``.
"""
