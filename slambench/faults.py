"""Faults planted under the timed path, for the readings that set the
correctness limits (``control.py --modes``) and for the tests that see
``correct`` come out false. Each takes the port's function and returns a
broken one; ``plant`` swaps it in where the port's modules call it."""

from __future__ import annotations

import dataclasses

import torch


def unchanged(orig):
    """A window solve that returns the state it was given."""
    def f(problem, cameras, imu_params, config):
        out = orig(problem, cameras, imu_params, config)
        state = torch.cat([problem.pose.reshape(-1), problem.speed_bias.reshape(-1),
                           problem.landmarks.reshape(-1), problem.extrinsics.reshape(-1)])
        return torch.cat([state.to(out.dtype), out[state.numel():]])
    return f


def half_rows(orig):
    """A window solve over every other observation row only."""
    def f(problem, cameras, imu_params, config):
        mask = problem.obs_mask.clone()
        mask[::2] = False
        return orig(problem.replace(obs_mask=mask), cameras, imu_params, config)
    return f


def fewer_iterations(orig):
    """A window solve cut to two LM iterations."""
    def f(problem, cameras, imu_params, config):
        return orig(problem, cameras, imu_params,
                    dataclasses.replace(config, max_iterations=min(config.max_iterations, 2)))
    return f


SOLVE_FAULTS = {"unchanged": unchanged, "half_rows": half_rows,
                "fewer_iterations": fewer_iterations}


def plant(name: str):
    """Swap the named fault in for the estimator's ``solve_packed``; returns
    a function that takes it out again."""
    from okvis2_torch.graph import estimator

    orig = estimator.solve_packed
    estimator.solve_packed = SOLVE_FAULTS[name](orig)

    def undo():
        estimator.solve_packed = orig
    return undo
