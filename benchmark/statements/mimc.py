"""MiMC statements: a secret input x0 asserted at step 0, and x_{n-1} of
x_{i+1} = x_i^3 + k[i mod 64] asserted at step n - 1.

Statement j starts at step 64 j of one chain of the recurrence drawn from
the seed, so every statement has its own input and output while making
`count` of them costs n + 64 (count - 1) steps of plain Python, not
count * n."""

from __future__ import annotations

from typing import List

from . import Statement, draw


def trace_steps(config: dict, traffic: dict) -> int:
    return traffic["steps"]


def make_all(config: dict, traffic: dict, seed: int, count: int) -> List[Statement]:
    p = config["field"]["modulus"]
    ks = [k % p for k in config["schema"]["static_registers"][0]["values"]]
    steps, period = traffic["steps"], len(ks)
    if steps % period:
        raise ValueError("the steps must be a multiple of the constants' period")
    head, last = ks[:-1], ks[-1]
    first_out = steps // period - 1
    x = draw(seed, 0, "mimc.chain", p)
    inputs, outputs = [], []
    for block in range(count + first_out):
        if block < count:
            inputs.append(x)
        for k in head:
            x = (x * x * x + k) % p
        if block >= first_out:
            outputs.append(x)          # x at step 64 block + 63
        x = (x * x * x + last) % p
    return [Statement(assertions=[(0, 0, x0), (steps - 1, 0, xn)], inputs=[[x0]], public=[],
                      shapes=[[1]]) for x0, xn in zip(inputs, outputs)]


def make(config: dict, traffic: dict, seed: int, index: int) -> Statement:
    return make_all(config, traffic, seed, index + 1)[index]
