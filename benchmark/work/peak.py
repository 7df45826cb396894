"""The card's peak rates, frozen here: its SM count (from PyTorch) and its
maximum SM clock (nvidia-smi) times the per-SM rates of its architecture, and
its name and power limit to print beside every number.

Hopper (compute capability 9.0; NVIDIA's H100 architecture whitepaper): 64
INT32 lanes per SM, a multiply-add counted as two operations; 4 tensor cores
of 1,024 dense int8 multiply-adds each. At the maximum SM clock these give a
little more than the data sheet's tensor-core rate, which is quoted at a
lower boost clock.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

PER_SM_CLOCK = {(9, 0): {"int32_ops": 2 * 64, "u8_tc_ops": 2 * 4 * 1024}}


class Peak(NamedTuple):
    name: str
    power_limit_w: float
    sms: int
    clock_hz: float
    int32_ops_per_s: float
    u8_tc_ops_per_s: float


def _smi(index: int, fields: str) -> list[str]:
    out = subprocess.run(["nvidia-smi", f"--id={index}", f"--query-gpu={fields}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return [v.strip() for v in out.strip().splitlines()[0].split(",")]


def card_peak(index: int = 0) -> Peak:
    import torch

    props = torch.cuda.get_device_properties(index)
    rates = PER_SM_CLOCK.get((props.major, props.minor))
    if rates is None:
        raise ValueError(f"no per-SM rates for compute capability {props.major}.{props.minor}")
    clock_mhz, power = _smi(index, "clocks.max.sm,power.limit")
    clock, sms = float(clock_mhz) * 1e6, props.multi_processor_count
    return Peak(torch.cuda.get_device_name(index), float(power), sms, clock,
                rates["int32_ops"] * sms * clock, rates["u8_tc_ops"] * sms * clock)
