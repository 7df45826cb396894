"""Drive the PyTorch port's pairing paths (the RNS tier's and the limb tier's)
on one CUDA card and hold them to their references.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from csrc/ and report nvcc's resource use; for
     the kernels on the tensor-core REDC (cyc_exp.cu, kara_exp.cu,
     kara_full.cu, tower_ops.cu, miller.cu) and the warp kernels (pow_static.cu,
     limb_tower.cu, mont.cu) each kernel's registers, shared memory and
     spills (none allowed, but in kara_full.cu: reported), and the IMMA
     instructions in the tensor-core sources' SASS;
  2. run each kernel on the card at the shapes the paths give it and hold it
     bit for bit to its plain PyTorch version (the tensor-core kernels also
     at ragged tile counts, the tower ops with an operand of row stride 0;
     the square runs also at the paths' run lengths, timed there too; the
     Miller kernels on the run's own points, miller_run with one and two
     terms;
     the warp kernels also at 1, 3, 5 and 127 rows, the limb tower kernel,
     conv, mont_reduce, mont_mul and mont_pow on row views too, conv and
     mont_mul with stride-0 operands;
     pow_static's recording build (a witness trace's chains) against its
     plain version at 128 and 3 rows, and its time;
     pow_static's time per dependent step against its latency model, and
     mont_pow's for one row and for 2048, beside the 608 mont_mul launches
     of the chain it replaces; mont_pow also for a 600-bit exponent, two
     launches);
     time both,
     count the kernel's bound from the inputs (the REDC base extensions at
     the tensor cores' u8 rate, and at the int32 rate beside it), and time
     conv's one PyTorch yardstick, a grouped float64 conv1d; conv at one
     cyclotomic squaring's launch of 30 pairs and at one pair, mont_reduce
     at a 12- and a 2-element stack;
  3. drive the paths at B = 2048 over distinct points k*G1, k*G2 (two
     of them at infinity), the launch counters reset just before each and
     checked just after:
       `pairing` (fused prepare+Miller, the miller_fused kernel): all 2048
         outputs against the
         exact-integer oracle (utils/refmodel.py, in a process pool started
         at the beginning) and the frozen vectors of
         tests/vectors/pairing_kat.json;
       `multi_pairing` with one term (the prepare_g2_lines and miller_run
         kernels): row for row the output of `pairing`;
       `pairing_check` with two terms: [P, -P] x [Q, Q] true everywhere,
         [P, P] x [Q, Q] true only where an input is at infinity; and a small
         `multi_pairing` batch of unrelated points against the oracle;
       `pairing(impl="karabina")` (the Karabina final exponentiation): all
         2048 outputs against the oracle, and the frozen vectors; then the
         final exponentiation of that batch's Miller-loop output under each
         of the six forms of its powers, each equal in value to the default
         form on all 2048 (the Granger-Scott forms row for row);
       the limb tier's `pairing` (models/pairing.py) on the same points under
         the strategies "auto" (conv, mont_reduce and mont_pow kernels under
         the plain tower composition, one conv launch per group of
         independent products) and "fused" (the four limb tower kernels as
         well): all 2048 outputs of each against the same oracle values, the
         frozen vectors, the two strategies equal in value; and the two-term
         `pairing_check` under "fused";
     and time each;
  4. profile one call of each path: device-busy share and the top kernels;
  5. capture each of `pairing`, `multi_pairing` with one term, the two
     two-term `pairing_check`s and the limb `pairing` under "fused" into a
     CUDA graph (utils/capture.py) from entry-style inputs (the generators),
     replay it on two other input sets (the run's points; the frozen
     vectors' points and the run's from ROLL on) and hold each replay to
     the eager call on the same inputs, 2048/2048 bit for bit, and to the
     path's own check (the oracle and the frozen vectors, or the checks'
     expected truth); time captured against eager calls, profile one replay,
     and report the capture's seconds and memory;
  6. the witness trace and checkpoint/resume (models/witness.py,
     utils/checkpoint.py) at B = 2048 on the run's points:
       (a) the traced RNS `pairing`, eager and captured (trace(jit=True)):
         its output the untraced pairing(impl="karabina")'s rows and the
         default pairing's values, 2048/2048; rns_mul / rns_inv records as
         the product trees and select-form Fermat chains give them (each
         chain one launch of pow_static's recording build), and at
         one packed row the CPU trace's counts and rows; check_trace all
         zeros, eager and captured, the captured rows the eager rows; one
         corrupted row per kind rejected; export_rows_u32 of every kind;
       (b) the hints at 2048 elements against the oracle: RNS sqrt_with_sgn,
         fq2.sqrt_with_sgn and fq2.inv, limb sqrt_with_sgn, fq2 sqrt, fq6 and
         fq12 inverses, traced, checked and exported (rns_sqrt and
         rns_fq2_sqrt included);
       (c) the traced limb `pairing` under "auto" (its Fermat chain as
         mont_mul launches), checked, against the oracle;
       (d) kill and resume on both tiers (every=17, fail_after_steps=17):
         the resumed rows the uninterrupted path's, 2048/2048, four
         miller_run launches per full RNS run; ms per chunk and the cost of
         a save and a load;
  7. data-parallel sharding (parallel/mesh.py, parallel/multihost.py) and
     the limb tier's num/den loop and canonical final exponentiation:
       (a) rns_pairing_and_product_sharded at world size 1, an NCCL group of
         this process (file:// rendezvous): e row for row the output of
         `multi_pairing` with one term, gt the oracle's product of the 2048
         pairings in value and rns_product_tree(e) row for row; one
         all_gather per call;
       (b) the same over two gloo ranks sharing the card (spawned processes
         that load phase 1's build), 512 packed rows each: e equal in value
         to (a)'s on all 2048 (identical rows counted: above fp.inv's 128-row
         tree floor they are not the same by construction), gt equal in value
         to (a)'s (rows compared and printed);
       (c) the num/den `optimized_pairing` under "fused" and "auto", equal
         in value to the limb `pairing` on 2048/2048, and the frozen
         vectors (e_chain); `final_exponentiation_canonical` of the limb
         Miller loop's output under "fused": its cube the limb `pairing` on
         2048/2048, and the frozen vectors (e_canonical);
       (d) entry.dryrun_multichip(1) on the card.
The second-to-last lines are the card's name and power limit and a JSON
object with each kernel's numbers; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from plonky2_bls12_381_pairing_torch import constants as LC
from plonky2_bls12_381_pairing_torch import entry
from plonky2_bls12_381_pairing_torch import rns_constants as RC
from plonky2_bls12_381_pairing_torch.models import pairing as lmp
from plonky2_bls12_381_pairing_torch.models import pairing_numden as lnd
from plonky2_bls12_381_pairing_torch.models import pairing_rns as mpr
from plonky2_bls12_381_pairing_torch.models import witness
from plonky2_bls12_381_pairing_torch.models.schedule import (_DO_SQUARE, _GS_SEGMENTS,
                                                             _IS_ADD, _KARA_SEGMENTS)
from plonky2_bls12_381_pairing_torch.ops import cuda_build
from plonky2_bls12_381_pairing_torch.ops import curve as lcurve
from plonky2_bls12_381_pairing_torch.ops import fp as lfp
from plonky2_bls12_381_pairing_torch.ops import fq2 as lfq2
from plonky2_bls12_381_pairing_torch.ops import fq6 as lfq6
from plonky2_bls12_381_pairing_torch.ops import fq12 as lfq12
from plonky2_bls12_381_pairing_torch.ops.kernels import mont as lmont
from plonky2_bls12_381_pairing_torch.ops.kernels import tower as ltower
from plonky2_bls12_381_pairing_torch.ops.rns import fp, kernel_tables, kernels, tower
from plonky2_bls12_381_pairing_torch.ops.rns import fq2 as rfq2
from plonky2_bls12_381_pairing_torch.ops.rns.lines import G1Affine, G2Affine
from plonky2_bls12_381_pairing_torch.parallel import mesh as pmesh
from plonky2_bls12_381_pairing_torch.parallel import multihost
from plonky2_bls12_381_pairing_torch.utils import checkpoint
from plonky2_bls12_381_pairing_torch.utils import refmodel as rm
from plonky2_bls12_381_pairing_torch.utils.capture import capture
from plonky2_bls12_381_pairing_torch.utils.profiling import (REDC_ROW, TC_OPS_PER_EXT_MAC, Work,
                                                             device_profile, lane_work,
                                                             recorded_elements)

KAT = Path(__file__).resolve().parent / "tests" / "vectors" / "pairing_kat.json"
TPU_KERNELS = "plonky2_bls12_381_pairing_tpu/ops/rns/pallas.py"
TPU_PAIRING_RNS = "plonky2_bls12_381_pairing_tpu/models/pairing_rns.py"
TPU_LIMB_MONT = "plonky2_bls12_381_pairing_tpu/ops/pallas/mont.py"
TPU_LIMB_TOWER = "plonky2_bls12_381_pairing_tpu/ops/pallas/tower.py"
#: pow_static's lax.scan over the mont_mul kernel
TPU_LIMB_FP = "plonky2_bls12_381_pairing_tpu/ops/fp.py"
PORT_CSRC = "plonky2_bls12_381_pairing_torch/csrc"
#: pairings per call and per term: the JAX package's batch per chip
BATCH = 2048
#: batch of the two-term multi_pairing held to the oracle
SMALL = 16

# Peak rates of one H100 SXM at its full 700 W limit (NVIDIA data sheet):
# HBM at 3.35 TB/s; int32 multiply-adds on 64 INT32 lanes per SM x 132 SMs at
# the 1.98 GHz boost clock, counted as two operations each, i.e. half the
# 67 TFLOP/s float32 rate; dense int8 tensor-core products at 1,979 Tops/s.
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 2 * 64 * 132 * CLOCK_HZ
U8_TC_OPS_PER_S = 1.979e15


# The operation model of RNS work (Work: int32 operations and base-extension
# multiply-adds; lane_work: channel products; REDC_ROW: one REDC row) is
# utils/profiling.py's.
#: channel products (one per lane) of a Granger-Scott squaring (9 Fq2
#: products of 3 each, 12 lifts) and of a full Fq12 product (18 Fq2 products)
CYC_SQ_PRODUCTS, FQ12_MUL_PRODUCTS = 9 * 3 + 12, 18 * 3
#: of a complex squaring (two Fq6 products of 6 Fq2 products), of the sparse
#: product mul_by_014 (5 + 3 + 5 Fq2 products) and of the Miller step's
#: coefficient scaling
FQ12_SQ_PRODUCTS, M014_PRODUCTS, ELL_SCALE_PRODUCTS = 12 * 3, 13 * 3, 4
#: of a Karabina squaring (4 Fq2 products, 8 lifts), and of one snapshot's
#: decompression: its REDC rows (4 numerator candidates, the norm, the
#: inverse over 4, the scaled conjugate, g1, g0) and its products (3 Fq2
#: products and 2 lifts for the numerators, 2 for the norm, 1 and 2 for the
#: scalings, an Fq2 product for g1, 3 Fq2 products and the lifted one for g0)
KARA_SQ_PRODUCTS = 4 * 3 + 8
DECOMPRESS_REDC_ROWS = 4 + 1 + 1 + 2 + 2 + 2
DECOMPRESS_PRODUCTS = (3 * 3 + 2) + 2 + 1 + 2 + 3 + (3 * 3 + 1)


# Operation model of the limb tier, per row: a 48 x 48 convolution is 2,304
# multiply-adds; the scan-free reduction is the truncated product by p' (the
# 51 low columns: 1,326 multiply-adds), the product by p (51 x 48), the
# quotient test (51) and its shift-add passes (a mask, a shift and an add on
# each of the 100 working columns); two operations per multiply-add.
LIMB_CONV_OPS = 2 * LC.NLIMBS * LC.NLIMBS


def limb_reduce_ops(first_passes: int) -> int:
    macs = LC.NRED * (LC.NRED + 1) // 2 + LC.NRED * LC.NLIMBS + LC.NRED
    return 2 * macs + 3 * 100 * (first_passes + lmont.NPASS_M + lmont.NPASS_S)


def limb_tower_ops(elements: int, name: str) -> int:
    """A formula's products, the signed sums of its 12 output wides (one
    multiply-add per product term and column) and its 12 reductions."""
    f = ltower.formula(name)
    combines = 2 * 95 * int(np.count_nonzero(f.outputs))
    return elements * (f.products * LIMB_CONV_OPS + combines
                       + 12 * limb_reduce_ops(f.first_passes))


def random_limb_rows(rng: np.random.Generator, *shape: int) -> np.ndarray:
    """Stored Fp rows (*shape, 48): uniform canonical digits with the top
    limb below p's, so every row is a residue below p."""
    rows = rng.integers(0, 256, (*shape, LC.NLIMBS), dtype=np.int32)
    rows[..., -1] = rng.integers(0, int(LC.P_LIMBS[-1]), shape, dtype=np.int32)
    return rows


def pow_mont_muls(exponent: int) -> int:
    """Products of fp.pow_static (mont_pow's dependent steps): a squaring per
    bit after the leading one, a multiply per set bit after it."""
    return exponent.bit_length() - 1 + bin(exponent).count("1") - 1


def cyc_exp_ops(elements: int, segments) -> Work:
    squares = sum(n for n, _ in segments)
    muls = sum(1 for _, m in segments if m)
    return (squares * tower_op_ops(elements, 12, CYC_SQ_PRODUCTS)
            + muls * tower_op_ops(elements, 12, FQ12_MUL_PRODUCTS))


def tower_op_ops(elements: int, redc_rows: int, products: int) -> Work:
    return elements * (redc_rows * REDC_ROW + lane_work(products))


def kara_chain_ops(elements: int, squarings: int) -> Work:
    """An 8-row REDC and four Fq2 products per compressed squaring."""
    return squarings * tower_op_ops(elements, 8, KARA_SQ_PRODUCTS)


def kara_full_ops(elements: int, segments) -> Work:
    """The least work for the value: the chain, the decompression of one
    snapshot per segment, the snapshots' product, and the inversion of all
    norms of the call shared by Montgomery's trick (three Fp products per
    norm around one Fermat power)."""
    n = len(segments)
    return (kara_chain_ops(elements, sum(segments))
            + n * tower_op_ops(elements, DECOMPRESS_REDC_ROWS, DECOMPRESS_PRODUCTS)
            + 3 * (n * elements - 1) * (REDC_ROW + lane_work(1)) + pow_ops(1, rm.P - 2)
            + (n - 1) * tower_op_ops(elements, 12, FQ12_MUL_PRODUCTS))


def miller_ops(elements: int, flags, terms: int = 1) -> Work:
    """Per step and term a 4-row and a 12-row REDC with the scaling's and the
    sparse product's lane products; per set flag a 12-row REDC with a
    squaring's."""
    steps, squares = len(flags), int(sum(flags))
    return (terms * steps * tower_op_ops(elements, 4 + 12,
                                         ELL_SCALE_PRODUCTS + M014_PRODUCTS)
            + squares * tower_op_ops(elements, 12, FQ12_SQ_PRODUCTS))


#: (REDC rows, channel products) of the line steps, counted from the plain
#: formulas (ops/rns/lines.py), by scale mode. doubling_step: stage 1 eight
#: rows and 4 Fq2 products, stage 2 ten rows and 6, stage 3 two rows and 1,
#: with scale=(py, px) four more rows and their 4 products. addition_step:
#: stages A-E 6 + 4 + 6 + 8 + 6 rows and 3 + 2 + 4 + 4 + 2 Fq2 products with
#: 8 lifts in stage D; with scale, c0 and c1 join stage D (12 rows) and
#: stage E's rows become the 4 scaling products.
DBL_STEP = {False: (20, 11 * 3), True: (24, 11 * 3 + 4)}
ADD_STEP = {False: (30, 15 * 3 + 8), True: (34, 15 * 3 + 8 + 4)}


def line_ops(elements: int, is_add, scaled: bool) -> Work:
    """The line steps of a schedule (one is_add flag per step)."""
    n_add = int(sum(is_add))
    dbl, add = DBL_STEP[scaled], ADD_STEP[scaled]
    return ((len(is_add) - n_add) * tower_op_ops(elements, *dbl)
            + n_add * tower_op_ops(elements, *add))


def miller_fused_ops(elements: int, is_add, do_square) -> Work:
    """The scaled line steps, then per step the sparse product's 12-row REDC
    and lane products, and per set flag a squaring."""
    return (line_ops(elements, is_add, True)
            + len(is_add) * tower_op_ops(elements, 12, M014_PRODUCTS)
            + int(sum(do_square)) * tower_op_ops(elements, 12, FQ12_SQ_PRODUCTS))


def nbytes(*tensors) -> int:
    """Bytes a kernel must move for these operands: the storage each one
    spans (a broadcast operand is read once), once."""
    return sum(t.untyped_storage().nbytes() if t.numel() and 0 in t.stride()
               else t.numel() * t.element_size() for t in tensors)


def pow_steps(exponent: int) -> int:
    """Dependent REDCs of one element: one per squaring and per multiply."""
    bits = fp.exponent_bits(exponent)
    return len(bits) + sum(bits)


def pow_ops(elements: int, exponent: int) -> Work:
    return elements * pow_steps(exponent) * (REDC_ROW + lane_work(1))


# Latency model of one dependent pow step, redc(mul(acc, .)), on its
# critical path in the warp design (csrc/pow_static.cu), in cycles. Assumed
# Hopper latencies: a dependent int32 multiply-add 4, and 2 cycles of issue
# per warp-wide multiply-add (16 INT32 lanes per SM sub-partition), a
# shared-memory store and load behind a __syncwarp 40, a shuffle 24, a
# Barrett reduction (convert, float product, convert back, multiply-add,
# select) 24. The path: the product and step 1's sigma (a multiply-add and a
# Barrett each), the sigma exchange, step 2's two 31-term dot products (62
# multiply-adds, issue-bound), the alpha shuffle, step 3 (qhat, then sigma':
# three multiply-adds and two Barretts), the sigma' exchange, step 4's
# 31-term dot product, the beta shuffle and its rounding (two operations),
# and the last Barrett behind a multiply-add.
IMAD_CYC, IMAD_ISSUE_CYC, XCHG_CYC, SHFL_CYC, BARRETT_CYC = 4, 2, 40, 24, 24
POW_STEP_CYC = (2 * (IMAD_CYC + BARRETT_CYC) + XCHG_CYC + 62 * IMAD_ISSUE_CYC + SHFL_CYC
                + (3 * IMAD_CYC + 2 * BARRETT_CYC) + XCHG_CYC + 31 * IMAD_ISSUE_CYC
                + (SHFL_CYC + 2 * IMAD_CYC) + (IMAD_CYC + BARRETT_CYC))


def bound_ms(nbytes: int, ops) -> tuple[float, str, float | None]:
    """The least time of the work, what bounds it, and for an RNS kernel
    (ops a Work) the bound with the base extensions priced at the int32 rate
    instead (the figure of earlier runs). Limb kernels give int32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if isinstance(ops, Work):
        t_ops = max(ops.int_ops / INT32_OPS_PER_S,
                    TC_OPS_PER_EXT_MAC * ops.ext_macs / U8_TC_OPS_PER_S) * 1e3
        int32_only = max(t_bytes, (ops.int_ops + 2 * ops.ext_macs) / INT32_OPS_PER_S * 1e3)
    else:
        t_ops, int32_only = ops / INT32_OPS_PER_S * 1e3, None
    return (t_ops, "operations", int32_only) if t_ops >= t_bytes else (t_bytes, "bytes",
                                                                       int32_only)


def prepared_conv(pairs: list) -> tuple:
    """One conv launch of `pairs` ((BATCH, 48) operands) with its argument
    struct, row views and output made once: calling the first element
    enqueues the kernel and nothing else; the second is the output."""
    arg, keep = lmont._ConvPairs(), []
    for i, (a, b) in enumerate(pairs):
        av, arg.sa[i] = lmont._rows48(a, (BATCH,))
        bv, arg.sb[i] = lmont._rows48(b, (BATCH,))
        arg.a[i], arg.b[i] = av.data_ptr(), bv.data_ptr()
        keep += [av, bv]
    out = torch.empty((len(pairs), BATCH, 95), dtype=torch.int32, device=pairs[0][0].device)
    entry = cuda_build.entry("conv")

    def launch():
        err = entry(ctypes.addressof(arg), len(pairs), out.data_ptr(), BATCH,
                    lmont.conv_rows_per_warp(len(pairs), BATCH),
                    torch.cuda.current_stream().cuda_stream)
        assert err == 0 and keep, f"conv launch failed: CUDA error {err}"

    return launch, out


def time_kernel(fn, reps: int, batch: int = 1) -> float:
    """Median milliseconds of one call, from CUDA events around `batch` calls
    (fn takes the call's index). With batch > 1 the stream is first held busy
    for about 10 ms so that the host has enqueued the whole batch before its
    first kernel starts: the events then time the kernels and not the host."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if batch > 1:
            torch.cuda._sleep(int(0.01 * CLOCK_HZ))
        start.record()
        for i in range(batch):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def host_times(fn, reps: int) -> list[float]:
    """Milliseconds of each of `reps` synchronised calls, on the host clock."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def time_host(fn, reps: int) -> float:
    """Median milliseconds of one synchronised call, on the host clock."""
    return statistics.median(host_times(fn, reps))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_fq12_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    ints = np.empty((n, 12), dtype=object)
    for idx in np.ndindex(ints.shape):
        ints[idx] = int.from_bytes(rng.bytes(48), "little") % rm.P
    return fp.encode(ints)


def random_fq2_rows(rng: np.random.Generator, n: int, comps: int) -> np.ndarray:
    """(rows, comps, LANES) stored Fp rows: comps / 2 Fq2 values per element."""
    ints = np.empty((n, comps), dtype=object)
    for idx in np.ndindex(ints.shape):
        ints[idx] = int.from_bytes(rng.bytes(48), "little") % rm.P
    return fp.encode(ints)


def fresh_operands(args: tuple) -> tuple:
    """A tower op's operands copied into new storage; the three Fq2 operands
    stay slices of one wider stack, as the paths hand them over."""
    if len(args) > 3:
        d = torch.cat(args[1:4], dim=-2)
        return (args[0].clone(), d[..., 0:2, :], d[..., 2:4, :], d[..., 4:6, :],
                *args[4:])
    return tuple(x.clone() for x in args)


def oracle_pairing(p: rm.G1Affine, q: rm.G2Affine) -> list[int]:
    """Exact-integer e(P, Q) coefficients (one at an infinity input)."""
    return rm.pairing(p, q).coeffs()


def oracle_multi_pairing(p0, q0, p1, q1) -> list[int]:
    return rm.multi_pairing([(p0, q0), (p1, q1)]).coeffs()


def points() -> tuple[list, list]:
    """P_i = (i+1) G1, Q_i = (2i+1) G2 for i < BATCH, with P_5 and Q_6 at
    infinity."""
    g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
    g2x2 = g2.add(g2)
    ps, qs = [g1], [g2]
    for _ in range(BATCH - 1):
        ps.append(ps[-1].add(g1))
        qs.append(qs[-1].add(g2x2))
    ps[5] = rm.G1Affine(0, 0, True)
    qs[6] = rm.G2Affine(rm.Fq2(0, 0), rm.Fq2(0, 0), True)
    return ps, qs


def profile_call(name: str, run, host_ops: bool = True) -> dict:
    """Device-busy share of one call and the kernels that take its device
    time (utils/profiling.py device_profile: torch.profiler, CUDA kernel
    events), printed. With host_ops False the host's operator events are not
    recorded: a limb call's quarter of a million launches make a trace whose
    host half takes minutes to digest."""
    prof = device_profile(run, host_ops=host_ops)
    if prof["device_ms"] is None:
        print(f"[profile] {name}: device time not measured: the profiler saw no "
              f"CUDA kernels")
        return {"device_ms": None, "kernel_launches": None}
    print(f"[profile] {name}: one call, profiler on: {prof['wall_ms']:.1f} ms wall, "
          f"{prof['device_ms']:.1f} ms of kernels ({100 * prof['busy']:.1f} % busy), "
          f"{prof['kernel_launches']} kernel launches")
    for ms, count, key in prof["top"]:
        print(f"[profile]   {ms:9.2f} ms {count:7d} x {key[:90]}")
    return {"device_ms": prof["device_ms"], "kernel_launches": prof["kernel_launches"]}


_T0 = time.perf_counter()


def mark(label: str) -> None:
    """Where the run's time goes: seconds since the script started."""
    print(f"[t] {time.perf_counter() - _T0:7.1f} s  {label}")


#: the sources whose kernels run the tensor-core REDC (csrc/rns_redc_tc.cuh)
TC_SOURCES = ("cyc_exp.cu", "kara_exp.cu", "kara_full.cu", "tower_ops.cu", "miller.cu")
#: kara_full's decompression and products spill a few words at the 64
#: registers of four 256-thread blocks per SM (PERF.md): reported, not held
#: to zero
SPILL_REPORTED = ("kara_full.cu",)
#: the sources of the warp kernels (mont.cu: conv, mont_reduce, mont_mul and
#: the mont_pow chain): their tables and scratch live in registers and
#: shared memory, no spills
WARP_SOURCES = ("pow_static.cu", "limb_tower.cu", "mont.cu")
#: row counts of the warp kernels' checks besides the paths' shapes: odd
#: counts that end the grid on a partial block
ODD_ROWS = (1, 3, 5, 127)
#: the square runs one exponentiation by |x| launches under "runs" and
#: "karabina_runs"
RUN_LENGTHS = {"cyc_square_run": tuple(n for n, _ in _GS_SEGMENTS),
               "kara_square_run": tuple(_KARA_SEGMENTS)}
#: the kernels on the tensor-core tile that phase 2 also runs at ragged
#: tile counts
RAGGED = ("cyc_exp_cond", "cyc_square_run", "kara_square_run", "kara_exp", "kara_full")
#: an exponent longer than one mont_pow launch takes (513 bits): 600 bits
LONG_EXPONENT = (1 << 599) | int.from_bytes(
    np.random.default_rng(600).bytes(75), "little") % (1 << 599)


def kernel_name(mangled: str) -> tuple[str, int]:
    """The kernel's name in a mangled symbol (the length-prefixed identifier
    that ends in _kernel; a namespace's hash before it may end in digits)
    and where it ends."""
    for i in range(len(mangled)):
        for k in (1, 2, 3):
            if mangled[i:i + k].isdigit():
                end = i + k + int(mangled[i:i + k])
                if mangled[i + k:end].endswith("_kernel"):
                    return mangled[i + k:end], end
    raise ValueError(f"no kernel name in {mangled}")


def ptxas_use(log: str) -> dict[str, str]:
    """ptxas's report per kernel of one source's build log (nvcc -Xptxas -v):
    its registers, shared memory and spills."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name, end = kernel_name(mangled)
            # the template's literal arguments: bool, int or enum values
            args = re.findall(r"L(NS_\d+[A-Za-z]\w*?E|[a-z])(-?\d+)E", mangled[end:])
            name += ("<" + ", ".join(("true" if v == "1" else "false") if t == "b" else v
                                     for t, v in args) + ">" if args else "")
            name = mangled if name in out else name
            out[name] = ""
        elif name is not None and ("spill" in line or "registers" in line):
            use = line.split(":", 1)[-1] if "ptxas" in line else line
            out[name] = f"{out[name]} {use.strip()}".strip()
    return out


def sass_count(lib: Path, opcode: str) -> int:
    """The SASS instructions of a built library whose opcode starts with
    `opcode`."""
    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return sum(f" {opcode}" in line.split(";")[0] for line in sass.splitlines())


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ragged_rows(rows: int) -> tuple[int, ...]:
    """Packed row counts below `rows` that end a tensor-core kernel's grid
    on a partial tile: 1, 3, a tile and one row, and `rows` - 1."""
    return tuple(n for n in (1, 3, kernel_tables.TC_ROWS + 1, rows - 1) if n < rows)


def final_exp_launches(impl: str) -> dict:
    """Launches of one final exponentiation, by kernel: 17 Fq12 products, 1
    cyclotomic squaring and the inverse's Fermat pow, and five times what an
    exponentiation by |x| launches in the form `impl`: one kernel; or 6 runs
    of squarings and 5 products; or the Karabina chain (one kernel, or 6
    runs), the shared inversion's Fermat pow and the 3 stacked products of
    the snapshots' tree."""
    per_exp = {
        "segments": {"cyc_exp": 1},
        "cond": {"cyc_exp_cond": 1},
        "runs": {"cyc_square_run": len(_GS_SEGMENTS),
                 "fq12_mul": sum(1 for _, m in _GS_SEGMENTS if m)},
        "karabina": {"kara_exp": 1, "fq12_mul": 3, "pow_static": 1},
        "karabina_runs": {"kara_square_run": len(_KARA_SEGMENTS), "fq12_mul": 3,
                          "pow_static": 1},
        "karabina_full": {"kara_full": 1},
    }[impl]
    out = {"fq12_mul": 17, "fq12_cyclotomic_square": 1, "pow_static": 1}
    for name, n in per_exp.items():
        out[name] = out.get(name, 0) + 5 * n
    return out


_FINAL_EXP = final_exp_launches("segments")
EXPECTED_LAUNCHES = {
    **{f"final_exp_{impl}": final_exp_launches(impl) for impl in mpr.EXP_IMPLS},
    # the fused prepare+Miller loop is one kernel
    "pairing_karabina": {**final_exp_launches("karabina"), "miller_fused": 1},
    "pairing": {**_FINAL_EXP, "miller_fused": 1},
    # one prepare kernel per term, one Miller loop kernel for all terms
    "multi_pairing_1": {**_FINAL_EXP, "prepare_g2_lines": 1, "miller_run": 1},
    "pairing_check_2": {**_FINAL_EXP, "prepare_g2_lines": 2, "miller_run": 1},
}
#: Kernels that no path launches: the Miller loops' ell and square, which
#: the Miller kernels now do inside (tower.mul_by_014 / square /
#: mul_by_014_square keep them for their other callers); phase 2 holds them
#: to their plain versions all the same. (The limb mont_mul is on phase 6's
#: paths: a traced Fermat chain and sgn0's from_mont.)
OFF_PATH = ("fq12_square", "fq12_mul_by_014", "fq12_mul_by_014_square")
# The limb tier. Under "auto" every product is composed of conv and
# mont_reduce launches: one conv launch per group of independent products
# (fp.form), one mont_reduce launch per stacked reduction; the Fermat
# inverse of the final exponentiation is one mont_pow launch;
# the limb tower kernels stay unused. Under "fused" the Miller loop's 68
# ells and 62 squares and the final exponentiation's products and
# cyclotomic squarings (two products of the easy part, then the hard part's
# program) are one tower kernel each.
_HP_OPS = lmp._HP_PROG[:, 0].tolist()
#: (conv, mont_reduce) launches of one call of each limb step under "auto"
#: (ops/lines.py, fq12.py, fq6.py, fq2.py, models/pairing.py _scale_coeffs):
#: a doubling step's three stages; an addition step's five stages of 15 Fq2
#: products reduced one by one; the coefficient scaling's two scalings; the
#: Frobenius map's two fq6 maps and its three gamma products (7 Fq2
#: products); the inverse's groups (the norm's squares, fq6.inv's products,
#: its norm, fq2.inv's two, the scalings, the two fq6 products)
#: fq6.inv: its two groups of products, each with its reductions (3 + 1),
#: fq2.inv's two (and its mont_pow), and the scalings' group (3)
_FQ6_INV = (5, 9)
LIMB_STEP_LAUNCHES = {
    "doubling_step": (3, 3), "addition_step": (5, 15), "scale_coeffs": (1, 2),
    "mul": (1, 1), "square": (1, 1), "mul_by_014": (1, 1), "cyclotomic_square": (1, 1),
    "frobenius_map": (2, 7), "fq6_inv": _FQ6_INV,
    # the num/den loop's Fq6 denominator and vertical lines (PR 14)
    "fq2_square": (1, 1), "fq6_mul": (1, 1), "fq6_square": (1, 1), "scale_verticals": (1, 1),
    # fq12.inv: the norm's squares and their reduction, fq6.inv, the two fq6
    # products and their two reductions
    "inv": (_FQ6_INV[0] + 2, _FQ6_INV[1] + 3),
}
#: the steps of the limb final exponentiation: the inverse, two products and
#: two Frobenius maps, then the hard part's program
FINAL_EXP_STEPS = {"inv": 1, "mul": 2 + _HP_OPS.count(lmp._OP_MUL),
                   "cyclotomic_square": _HP_OPS.count(lmp._OP_CYCSQ),
                   "frobenius_map": 2 + _HP_OPS.count(lmp._OP_FROB)}


def limb_step_launches(steps: dict, strategy: str = "auto") -> dict:
    """Exact launches of the limb steps `steps` ({step: calls}): conv and
    mont_reduce by LIMB_STEP_LAUNCHES, a mont_pow per inverse, and under
    "fused" one limb tower kernel per Fq12 tower step."""
    tower = ("mul", "square", "mul_by_014", "cyclotomic_square")
    out = {"conv": 0, "mont_reduce": 0,
           "mont_pow": steps.get("inv", 0) + steps.get("fq6_inv", 0)}
    for step, n in steps.items():
        if strategy == "fused" and step in tower:
            out[f"limb_fq12_{step}"] = n
            continue
        out["conv"] += n * LIMB_STEP_LAUNCHES[step][0]
        out["mont_reduce"] += n * LIMB_STEP_LAUNCHES[step][1]
    return out


def limb_launches(strategy: str, terms: int) -> dict:
    """Exact launches of the limb tier's pairing / multi_pairing of `terms`
    terms: prepare (63 doubling and 5 addition steps per term), the Miller
    loop (a scaling per term, 68 ells per term, 62 squares), the final
    exponentiation (FINAL_EXP_STEPS)."""
    return limb_step_launches(
        {"doubling_step": 63 * terms, "addition_step": 5 * terms, "scale_coeffs": terms,
         "mul_by_014": 68 * terms, "square": 62, **FINAL_EXP_STEPS}, strategy)




#: Phase 7. The num/den pairing: the flagship's prepare with a vertical (an
#: Fq2 square) per step, the Miller loop's 68 ells, an Fq6 product per line
#: and an Fq6 square per iteration, the one Fq6 inverse and the product by
#: it, then the chain final exponentiation
NUMDEN_STEPS = dict(Counter(
    {"doubling_step": 63, "addition_step": 5, "fq2_square": 68, "scale_coeffs": 1,
     "scale_verticals": 1, "mul_by_014": 68, "fq6_mul": 68, "square": 62, "fq6_square": 62,
     "fq6_inv": 1, "mul": 1}) + Counter(FINAL_EXP_STEPS))
#: the canonical final exponentiation: the easy part (an inverse, two
#: products, two Frobenius maps), then per base-p digit d_i of the hard part
#: a square per bit after the leading one, a product per set bit after it,
#: i Frobenius maps, and a product into the result after the first
CANONICAL_STEPS = {
    "inv": 1,
    "mul": 2 + sum(bin(d).count("1") - 1 for d in lmp.C_HARD_DIGITS)
    + len(lmp.C_HARD_DIGITS) - 1,
    "cyclotomic_square": sum(d.bit_length() - 1 for d in lmp.C_HARD_DIGITS),
    "frobenius_map": 2 + sum(range(len(lmp.C_HARD_DIGITS)))}


def tree_muls(rows: int) -> int:
    """Fq12 products of rns_product_tree over `rows` packed rows: one per
    level of the fold (padded to a power of two), one across the slots."""
    return (rows - 1).bit_length() + 1


EXPECTED_LAUNCHES.update({
    "numden_fused": limb_step_launches(NUMDEN_STEPS, "fused"),
    "numden_auto": limb_step_launches(NUMDEN_STEPS, "auto"),
    "canonical_fused": limb_step_launches(CANONICAL_STEPS, "fused"),
    "limb_pairing_auto": limb_launches("auto", 1),
    "limb_pairing_fused": limb_launches("fused", 1),
    "limb_pairing_check_2_fused": limb_launches("fused", 2),
})

# Phase 6. A trace runs the RNS exponentiations as "karabina" (kara_exp
# stays a kernel) and each Fermat chain in its recording form: the RNS
# chains as one launch each of pow_static's recording build, so the launches
# are those of the untraced pairing(impl="karabina"); the limb chain as one
# mont_mul launch per product (two per bit of p - 2 after its leading one);
# every other kernel as untraced.
FERMAT_PRODUCTS = 2 * ((rm.P - 2).bit_length() - 1)
_TRACED_FINAL_EXP = final_exp_launches("karabina")
_LIMB_TRACED = {**limb_launches("auto", 1), "mont_pow": 0, "mont_mul": FERMAT_PRODUCTS}


def chain_products(exponent: int) -> int:
    """Products of a static square-and-multiply chain: a squaring per bit
    after the leading one and a product per set bit among them."""
    return exponent.bit_length() - 1 + bin(exponent).count("1") - 1


#: Fq2 products of the limb fq2.sqrt (ops/fq2.py): the two chains by
#: (p - 3)/4 and (p - 1)/2, then x0, alpha and the last product; each is
#: one conv and one mont_reduce launch; sgn0 adds a mont_mul per component
FQ2_SQRT_PRODUCTS = chain_products((rm.P - 3) // 4) + chain_products((rm.P - 1) // 2) + 3
EXPECTED_LAUNCHES.update({
    "witness_pairing": {**_TRACED_FINAL_EXP, "miller_fused": 1},
    # the warm-up call and the captured call (a replay launches nothing)
    "witness_pairing_captured": {k: 2 * v for k, v in _TRACED_FINAL_EXP.items()}
    | {"miller_fused": 2},
    "witness_limb_pairing": _LIMB_TRACED,
    # the hints, untraced: the Fermat chains are kernels again. The RNS Fq2
    # root's chains are Fq2 products of plain formulas (ops/rns/fq2.py, as
    # in the JAX package, where no Pallas kernel takes them)
    "hint_rns_sqrt": {"pow_static": 1},
    "hint_rns_fq2_sqrt": {},
    "hint_rns_fq2_inv": {"pow_static": 1},
    "hint_limb_sqrt": {"mont_pow": 1, "mont_mul": 1},
    "hint_limb_fq2_sqrt": {"conv": FQ2_SQRT_PRODUCTS, "mont_reduce": FQ2_SQRT_PRODUCTS,
                           "mont_mul": 2},
    "hint_limb_fq6_inv": limb_step_launches({"fq6_inv": 1}),
    "hint_limb_fq12_inv": limb_step_launches({"inv": 1}),
    # checkpointed runs, 68 steps in chunks of 17: one miller_run per chunk
    "checkpoint_rns_kill": {"miller_run": 1},
    "checkpoint_rns_resume": {**_FINAL_EXP, "miller_run": 3},
    "checkpoint_rns": {**_FINAL_EXP, "miller_run": 4},
    # the limb chunks: the coefficients' scaling (once per start), the ells
    # and squares of the steps run, then the final exponentiation
    "checkpoint_limb_kill": limb_step_launches(
        {"scale_coeffs": 1, "mul_by_014": 17, "square": int(_DO_SQUARE[:17].sum())}),
    "checkpoint_limb_resume": limb_step_launches(
        {"scale_coeffs": 1, "mul_by_014": 51, "square": int(_DO_SQUARE[17:].sum()),
         **FINAL_EXP_STEPS}),
})


def inv_mul_records(n: int) -> int:
    """rns_mul records of one traced fp.inv of n rows: per level of the
    product tree above its 128-row floor one product up and two down, and
    the select-form Fermat chain's products."""
    size, levels = 1, 0
    while size < n:
        size *= 2
    while size > fp._TREE_FLOOR:
        size //= 2
        levels += 1
    return 3 * levels + FERMAT_PRODUCTS


def drive(name: str, run):
    """One call of a path with the launch counters (both tiers') reset just
    before and read and checked just after. An expected count is a number,
    or None for a kernel that must have been launched at least once."""
    torch.cuda.synchronize()
    cuda_build.reset_all_launches()
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    counts = cuda_build.all_launches()
    print(f"[{name}] B={BATCH}: first call {first_s:.2f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for k, n in counts.items():
        want = EXPECTED_LAUNCHES[name].get(k, 0)
        assert n > 0 if want is None else n == want, (name, k, n, want)
    return out, counts


def time_path(name: str, run, card: str, reps: int = 3) -> dict:
    times = host_times(run, reps)
    ms = statistics.median(times)
    rate = BATCH / (ms / 1e3)
    print(f"[{name}] B={BATCH}: {ms:.1f} ms per call (min {min(times):.1f}, max "
          f"{max(times):.1f} of {reps}), {rate:.1f} per s on {card}")
    return {"batch": BATCH, "ms": ms, "ms_min": min(times), "ms_max": max(times),
            "per_s": rate, "card": card}


#: set B of phase 5: the frozen vectors' points, then the run's points from
#: this index on (their order turned round)
ROLL = 1000


def elements_equal(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of the batch whose outputs are equal: an RNS output (rows,
    ..., LANES) packs two elements a row, a limb output has one a row, a
    check's bools one each."""
    eq = got == want
    if got.shape[-1] == RC.LANES:
        eq = eq.reshape(eq.shape[0], -1, RC.PACK, RC.SUB).all(dim=-1).all(dim=1)
    elif got.dtype != torch.bool:
        eq = eq.reshape(eq.shape[0], -1).all(dim=1)
    return int(eq.reshape(-1)[:BATCH].sum().item())


def capture_phase(card: str, paths: dict) -> dict:
    """Phase 5: each path captured once (utils/capture.py) from the
    entry-style inputs, then replayed on two other input sets; on each the
    replay's rows equal the eager call's, 2048/2048, and pass the path's own
    check. Also: captured against eager ms per call (median of 3,
    synchronised), one replay's device ms and busy share (device_profile)
    and its span between two CUDA events, the capture's seconds and peak
    memory."""
    out = {}
    for name, (fn, example, sets, verify) in paths.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step = capture(fn, *example)
        held = torch.cuda.memory_allocated() - before
        peak = torch.cuda.max_memory_allocated() - before
        print(f"[capture {name}] captured in {step.capture_seconds:.2f} s (one eager call and "
              f"the capture); peak memory {peak / 2**20:.1f} MiB above the {before / 2**20:.1f} "
              f"MiB the run held, {held / 2**20:.1f} MiB held by the graph and its buffers")
        replays = []
        for k, args in enumerate(sets):
            got = step(*args)
            want = fn(*args)
            torch.cuda.synchronize()
            n_eq = elements_equal(got, want)
            print(f"[capture {name}] input set {k + 1}: replay equals the eager call on "
                  f"{n_eq}/{BATCH}")
            assert n_eq == BATCH and torch.equal(got, want), (name, k, n_eq)
            verify(k, got)
            replays.append(got)
        # (a check's truth may be the same on both sets)
        assert replays[0].dtype == torch.bool or not torch.equal(*replays), (
            f"{name}: the two input sets gave the same rows")
        eager = host_times(lambda: fn(*sets[0]), 3)
        captured = host_times(lambda: step(*sets[0]), 3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        step.graph.replay()
        end.record()
        end.synchronize()
        span = start.elapsed_time(end)
        prof = device_profile(lambda: step(*sets[0]), host_ops=False)
        res = {"batch": BATCH, "capture_s": step.capture_seconds, "peak_bytes_above": peak,
               "graph_bytes": held, "eager_ms": statistics.median(eager),
               "eager_ms_min": min(eager), "eager_ms_max": max(eager),
               "captured_ms": statistics.median(captured), "captured_ms_min": min(captured),
               "captured_ms_max": max(captured), "replay_span_ms": span,
               "replay_device_ms": prof["device_ms"], "replay_busy": prof["busy"],
               "replay_kernels": prof["kernel_launches"], "card": card}
        res["eager_per_s"] = BATCH / (res["eager_ms"] / 1e3)
        res["captured_per_s"] = BATCH / (res["captured_ms"] / 1e3)
        # busy share: the replay's kernel time over the unprofiled ms per
        # call, as phase 4's shares are read (the profiled call's own is
        # printed beside it)
        res["captured_busy"] = (None if prof["device_ms"] is None
                                else prof["device_ms"] / res["captured_ms"])
        dev_note = ("device ms not measured (the profiler saw no kernel)"
                    if prof["device_ms"] is None else
                    f"device {prof['device_ms']:.1f} ms in {prof['kernel_launches']} kernels, "
                    f"{100 * res['captured_busy']:.1f} % busy ({100 * prof['busy']:.1f} % "
                    f"of the profiled call's {prof['wall_ms']:.1f} ms)")
        print(f"[capture {name}] B={BATCH}: captured {res['captured_ms']:.1f} ms per call "
              f"(min {min(captured):.1f}, max {max(captured):.1f}), eager "
              f"{res['eager_ms']:.1f} ms (min {min(eager):.1f}, max {max(eager):.1f}); "
              f"{res['captured_per_s']:.1f} against {res['eager_per_s']:.1f} per s; one "
              f"replay: {span:.2f} ms between events, {dev_note}; on {card}")
        out[name] = res
        del step, replays, got, want
        mark(f"captured {name}")
    return out


def rows_of(p, n: int):
    """The first n rows of a point dataclass's tensors (n packed rows on the
    RNS tier)."""
    return type(p)(**{k: getattr(p, k)[:n] for k in ("x", "y", "infinity")})


def traces_equal(a: witness.WitnessTrace, b: witness.WitnessTrace) -> bool:
    """The same kinds, counts and rows, bit for bit (on the CPU)."""
    if a.counts() != b.counts():
        return False
    return all(torch.equal(x.cpu(), y.cpu())
               for op in a.rows for ra, rb in zip(a.rows[op], b.rows[op])
               for x, y in zip(ra, rb))


def check_clean(name: str, tr: witness.WitnessTrace) -> float:
    """check_trace all zeros; its ms per 1,000 recorded rows on the host
    clock."""
    n = sum(recorded_elements(tr).values())
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = witness.check_trace(tr)
    ms = (time.perf_counter() - t) * 1e3
    print(f"[{name}] check_trace {result} over {n} rows in {ms:.1f} ms "
          f"({ms / n * 1e3:.4f} ms per 1k rows)")
    assert result and all(v == 0 for v in result.values()), (name, result)
    return ms / n * 1e3


def corrupted_rejected(name: str, tr: witness.WitnessTrace) -> None:
    """One residue or limb of each kind's first output + 1 is rejected."""
    for op, rows in tr.rows.items():
        row = list(rows[0])
        bad = row[-1].clone()
        bad.view(-1)[0] += 1
        one = witness.WitnessTrace()
        one.add(op, tuple(row[:-1]) + (bad,))
        n = witness.check_trace(one)[op]
        print(f"[{name}] one corrupted {op} row: {n} rows rejected")
        assert n > 0, (name, op)


def export_all(name: str, tr: witness.WitnessTrace) -> float:
    """export_rows_u32 of every kind; ms per 1,000 recorded rows."""
    n = sum(recorded_elements(tr).values())
    t = time.perf_counter()
    ex = witness.export_rows_u32(tr)
    ms = (time.perf_counter() - t) * 1e3
    for op, rows in ex.items():
        assert len(rows) == len(tr.rows[op])
        for i, slot in enumerate(rows[0]):
            flag = i in witness._FLAG_SLOTS.get(op, ())
            assert flag or (slot.dtype == np.uint32 and slot.shape[-1] == witness.U32_LIMBS)
    print(f"[{name}] export_rows_u32 of {sorted(ex)}: {n} rows in {ms:.1f} ms "
          f"({ms / n * 1e3:.4f} ms per 1k rows)")
    return ms / n * 1e3


def witness_phase(card: str, drive, path_counts: dict, pts: dict) -> dict:
    """Phase 6 (module docstring): the witness trace and checkpoint/resume
    on both tiers at B = 2048. pts: the run's RNS and limb points, the
    untraced rows they are held to, and the oracle's rows."""
    dev = pts["p"].x.device
    rows = pts["p"].x.shape[0]
    res: dict = {"card": card}
    # (a) the traced RNS pairing, eager
    p, q, want_rows = pts["p"], pts["q"], pts["want_rows"]
    (out_t, tr), path_counts["witness_pairing"] = drive(
        "witness_pairing", lambda: witness.trace(mpr.pairing, p, q))
    n_rows = elements_equal(out_t, pts["karabina"])
    n_val = int(tower.is_equal(out_t, pts["pairing"]).reshape(-1)[:BATCH].sum().item())
    print(f"[witness_pairing] rows of pairing(impl='karabina') on {n_rows}/{BATCH}, "
          f"values of pairing on {n_val}/{BATCH}; records {tr.counts()}")
    assert n_rows == BATCH and n_val == BATCH
    want_counts = {"rns_mul": inv_mul_records(rows) + 5 * inv_mul_records(6 * rows),
                   "rns_inv": 6}
    assert tr.counts() == want_counts, (tr.counts(), want_counts)
    # at one packed row, the CPU trace's kinds, counts and rows
    p1, q1 = rows_of(p, 1), rows_of(q, 1)
    _, tr1 = witness.trace(mpr.pairing, p1, q1)
    _, tr1_cpu = witness.trace(mpr.pairing, fp._on_cpu(p1), fp._on_cpu(q1))
    same1 = traces_equal(tr1, tr1_cpu)
    print(f"[witness_pairing] one packed row: card {tr1.counts()}, CPU "
          f"{tr1_cpu.counts()}, rows identical: {same1}")
    assert same1
    del tr1, tr1_cpu
    res["check_ms_per_1k_rows"] = check_clean("witness_pairing", tr)
    corrupted_rejected("witness_pairing", tr)
    res["export_ms_per_1k_rows"] = export_all("witness_pairing", tr)
    # and captured: the sink on only while the graph is captured
    (out_c, tr_c), path_counts["witness_pairing_captured"] = drive(
        "witness_pairing_captured", lambda: witness.trace(mpr.pairing, p, q, jit=True))
    same = torch.equal(out_c, out_t) and traces_equal(tr_c, tr)
    print(f"[witness_pairing_captured] output and every recorded row the eager trace's: "
          f"{same}")
    assert same
    check_clean("witness_pairing_captured", tr_c)
    del tr_c, out_c
    traced = host_times(lambda: witness.trace(mpr.pairing, p, q), 3)
    untraced = host_times(lambda: mpr.pairing(p, q, impl="karabina"), 3)
    default = host_times(lambda: mpr.pairing(p, q), 3)
    res["traced_ms"], res["untraced_karabina_ms"] = (statistics.median(traced),
                                                     statistics.median(untraced))
    res["untraced_ms"] = statistics.median(default)
    res["records_per_call"] = tr.counts()
    res["rows_per_call"] = recorded_elements(tr)
    print(f"[witness_pairing] B={BATCH}: traced {res['traced_ms']:.1f} ms per call, "
          f"untraced pairing(impl='karabina') {res['untraced_karabina_ms']:.1f} ms, "
          f"pairing {res['untraced_ms']:.1f} ms (median of 3); rows per call "
          f"{res['rows_per_call']}; on {card}")
    del tr, out_t
    torch.cuda.empty_cache()
    mark("the traced RNS pairing")

    # (b) the hints at 2048 elements against the oracle
    rng = np.random.default_rng(0x6E)

    def ints(n):
        return [int.from_bytes(rng.bytes(48), "little") % rm.P for _ in range(n)]

    def fq2s(n):
        return [rm.Fq2(*ints(2)) for _ in range(n)]

    def enc2(zs):
        arr = np.empty((len(zs), 2), dtype=object)
        for i, z in enumerate(zs):
            arr[i, 0], arr[i, 1] = z.c0, z.c1
        return torch.from_numpy(fp.encode(arr)).to(dev)

    def dec2(t):
        v = fp.decode(t)
        return [rm.Fq2(int(v[i, 0]), int(v[i, 1])) for i in range(BATCH)]

    xs = ints(BATCH)
    xs[7] = 0
    sq = [x * x % rm.P for x in xs]
    sgn = rng.integers(0, 2, BATCH).astype(np.int32)
    sgn[[3, 7]] = 0  # a zero root's sign is 0: the constraint a trace checks
    sgn_packed = torch.from_numpy(sgn.reshape(-1, RC.PACK).copy()).to(dev)
    z2 = fq2s(BATCH)
    z2[3] = rm.Fq2(0, 0)
    sq2 = [z.square() for z in z2]
    hints = {
        "hint_rns_sqrt": (lambda: fp.sqrt_with_sgn(torch.from_numpy(fp.encode(sq)).to(dev),
                                                   sgn_packed),
                          lambda out: [int(v) for v in fp.decode(out)[:BATCH]],
                          lambda r: all(v * v % rm.P == s and (v & 1 == g or v == 0)
                                        for v, s, g in zip(r, sq, sgn))),
        "hint_rns_fq2_sqrt": (lambda: rfq2.sqrt_with_sgn(enc2(sq2), sgn_packed), dec2,
                              lambda r: all(v.square() == s and (rm.sgn0_fq2(v) == g
                                                                 or v == rm.Fq2(0, 0))
                                            for v, s, g in zip(r, sq2, sgn))),
        "hint_rns_fq2_inv": (lambda: rfq2.inv(enc2(z2)), dec2,
                             lambda r: all((v * z == rm.Fq2(1, 0)) or (z == rm.Fq2(0, 0)
                                                                      and v == z)
                                           for v, z in zip(r, z2))),
    }
    lx = torch.from_numpy(lfp.encode(sq)).to(dev)
    lsgn = torch.from_numpy(sgn).to(dev)
    lz2 = torch.from_numpy(lfq2.encode(sq2)).to(dev)
    r6 = [rm.Fq6(*fq2s(3)) for _ in range(BATCH)]
    r12 = [rm.Fq12(rm.Fq6(*fq2s(3)), rm.Fq6(*fq2s(3))) for _ in range(BATCH)]
    hints.update({
        "hint_limb_sqrt": (lambda: lfp.sqrt_with_sgn(lx, lsgn),
                           lambda out: [int(v) for v in lfp.decode(out)],
                           hints["hint_rns_sqrt"][2]),
        "hint_limb_fq2_sqrt": (lambda: lfq2.sqrt_with_sgn(lz2, lsgn),
                               lambda out: list(lfq2.decode(out)), hints["hint_rns_fq2_sqrt"][2]),
        "hint_limb_fq6_inv": (lambda: lfq6.inv(torch.from_numpy(lfq6.encode(r6)).to(dev)),
                              lambda out: list(lfq6.decode(out)),
                              lambda r: all(v * x == rm.Fq6.one() for v, x in zip(r, r6))),
        "hint_limb_fq12_inv": (lambda: lfq12.inv(torch.from_numpy(lfq12.encode(r12)).to(dev)),
                               lambda out: list(lfq12.decode(out)),
                               lambda r: all(v * x == rm.Fq12.one() for v, x in zip(r, r12))),
    })
    res["hints_ms"] = {}
    for name, (run, decode, ok) in hints.items():
        out, path_counts[name] = drive(name, run)
        good = ok(decode(out))
        ms = statistics.median(host_times(run, 3))
        res["hints_ms"][name] = ms
        print(f"[{name}] {BATCH} elements against the oracle: {good}; {ms:.1f} ms per call "
              f"on {card}")
        assert good, name
    # traced, the sqrt and inverse hints leave their kinds' rows; exported,
    # the RNS sign slots pass through
    _, htr = witness.trace(lambda: (hints["hint_rns_sqrt"][0](), hints["hint_rns_fq2_sqrt"][0](),
                                    hints["hint_rns_fq2_inv"][0](), hints["hint_limb_sqrt"][0](),
                                    hints["hint_limb_fq2_sqrt"][0](),
                                    hints["hint_limb_fq6_inv"][0]()))
    print(f"[hints] traced: {htr.counts()}")
    assert {"rns_sqrt", "rns_fq2_sqrt", "rns_fq2_inv", "sqrt", "fq2_sqrt",
            "fq6_inv"} <= set(htr.counts())
    check_clean("hints", htr)
    corrupted_rejected("hints", htr)
    export_all("hints", htr)
    del htr
    torch.cuda.empty_cache()
    mark("the hints")

    # (c) the traced limb pairing under "auto"
    lp, lq = pts["lp"], pts["lq"]
    (lout, ltr), path_counts["witness_limb_pairing"] = drive(
        "witness_limb_pairing", lambda: witness.trace(lmp.pairing, lp, lq))
    got = lfp.decode(lout)
    bad = [i for i in range(BATCH) if list(got[i]) != want_rows[i]]
    print(f"[witness_limb_pairing] vs oracle: {BATCH - len(bad)}/{BATCH} bit-exact; records "
          f"{ltr.counts()}")
    assert not bad and ltr.counts()["mul"] == FERMAT_PRODUCTS
    check_clean("witness_limb_pairing", ltr)
    corrupted_rejected("witness_limb_pairing", ltr)
    res["limb_traced_ms"] = statistics.median(host_times(lambda: witness.trace(lmp.pairing,
                                                                               lp, lq), 3))
    res["limb_untraced_ms"] = statistics.median(host_times(lambda: lmp.pairing(lp, lq), 3))
    print(f"[witness_limb_pairing] B={BATCH}: traced {res['limb_traced_ms']:.1f} ms per call, "
          f"untraced {res['limb_untraced_ms']:.1f} ms (median of 3) on {card}")
    del ltr, lout
    mark("the traced limb pairing")

    # (d) kill and resume on both tiers
    ckdir = Path(__file__).resolve().parent / "chiprun_out" / "checkpoints"
    ckdir.mkdir(parents=True, exist_ok=True)
    prepared = mpr.prepare_g2_stepmajor(q)
    lprepared = lmp.prepare_g2(lq)
    tiers = {
        "rns": (lambda path, **kw: checkpoint.run_pairing_checkpointed_rns(
            p, prepared, q.infinity, ckpt_path=path, **kw), pts["pairing"]),
        "limb": (lambda path, **kw: checkpoint.run_pairing_checkpointed(
            lp, lprepared, lq.infinity, ckpt_path=path, **kw), lmp.pairing(lp, lq)),
    }
    for tier, (run, want) in tiers.items():
        path = str(ckdir / f"{tier}.npz")
        if os.path.exists(path):
            os.remove(path)

        def kill():
            try:
                run(path, every=17, fail_after_steps=17)
            except RuntimeError as err:
                assert "injected failure" in str(err)
                return None
            raise AssertionError("fail_after_steps did not stop the run")

        _, path_counts[f"checkpoint_{tier}_kill"] = drive(f"checkpoint_{tier}_kill", kill)
        _, start = checkpoint.load_state(path)
        assert start == 17
        got, path_counts[f"checkpoint_{tier}_resume"] = drive(
            f"checkpoint_{tier}_resume", lambda: run(path, every=17))
        n_eq = elements_equal(got, want)
        print(f"[checkpoint_{tier}] killed after step 17, resumed: rows of the uninterrupted "
              f"path on {n_eq}/{BATCH}")
        assert n_eq == BATCH and torch.equal(got, want)
    full_path = ckdir / "full.npz"
    if full_path.exists():
        full_path.unlink()
    full, path_counts["checkpoint_rns"] = drive(
        "checkpoint_rns", lambda: tiers["rns"][0](str(full_path), every=17))
    assert torch.equal(full, pts["pairing"])
    # a chunk's cost beside a save and a load of its state
    skip = ((p.infinity != 0) | (q.infinity != 0)).to(torch.int32)
    f0 = tower.one((rows,), dev)
    chunk = time_kernel(lambda i: kernels.miller_run(f0, prepared[:17], p.y, p.x, skip,
                                                     _DO_SQUARE[:17]), 5)
    scaled = lmp.stack_steps(lmp.scale_all_coeffs(lp, lprepared, lq.infinity)[1])
    lf0 = lfq12.one((), dev).expand(BATCH, 12, LC.NLIMBS)
    lchunk = statistics.median(host_times(lambda: lmp.miller_steps(lf0, scaled[:17],
                                                                   _DO_SQUARE[:17]), 3))
    state = str(ckdir / "state.npz")
    facc = f0.contiguous()
    save = statistics.median(host_times(lambda: checkpoint.save_state(state, facc, 17), 3))
    load = statistics.median(host_times(
        lambda: torch.from_numpy(checkpoint.load_state(state)[0]).to(dev), 3))
    res["checkpoint"] = {"rns_chunk_ms": chunk, "limb_chunk_ms": lchunk, "save_ms": save,
                         "load_ms": load, "state_bytes": f0.numel() * 4,
                         "chunks_per_run": 4}
    print(f"[checkpoint] 17-step chunk: RNS one miller_run {chunk:.3f} ms (device), limb "
          f"{lchunk:.1f} ms (host clock); save {save:.1f} ms, load {load:.1f} ms of the "
          f"{f0.numel() * 4 / 2**20:.1f} MiB RNS state; on {card}")
    for f in ckdir.glob("*.npz"):
        f.unlink()
    mark("checkpoint and resume")
    return res


def sharded_rank(rank: int, size: int, rendezvous: str, device: str, p, q) -> dict:
    """One rank of phase 7's two gloo ranks on one card (spawned; found here
    by its import path): this rank's packed rows of the global points (p, q,
    on the CPU), the sharded RNS pairing and product once to load the
    kernels, then counted and timed calls. Returns numpy rows."""
    dev = multihost.initialize(rendezvous, size, rank, backend="gloo", device=device)
    mesh = pmesh.make_mesh(device=dev)
    sp, sq = pmesh.shard_points_rns(p, q, mesh)
    fn = pmesh.rns_pairing_and_product_sharded(mesh)
    fn(sp, sq)
    torch.cuda.synchronize()
    cuda_build.reset_all_launches()
    pmesh.reset_collectives()
    e, gt = fn(sp, sq)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_build.all_launches().items() if v}
    gathers = pmesh.collectives["all_gather"]
    times = host_times(lambda: fn(sp, sq), 3)
    return {"e": e.cpu().numpy(), "gt": gt.cpu().numpy(), "launches": launches,
            "all_gather": gathers, "ms": times, "backend": dist.get_backend(),
            "device": str(dev), "jax": "jax" in sys.modules}


def sharding_phase(card: str, drive, path_counts: dict, pts: dict) -> dict:
    """Phase 7 (module docstring): the sharded RNS pairing and product at
    world sizes 1 (NCCL, in this process) and 2 (gloo ranks sharing the
    card), the limb tier's num/den pairing and canonical final
    exponentiation, and the entry's dry run. pts: the run's points (on the
    card and on the CPU), the frozen vectors' points and values, the rows of
    phase 3 they are held to, and the oracle's rows."""
    dev = pts["p"].x.device
    rows = pts["p"].x.shape[0]
    res: dict = {"card": card}
    EXPECTED_LAUNCHES["sharded_rns_1"] = {
        **_FINAL_EXP, "prepare_g2_lines": 1, "miller_run": 1,
        "fq12_mul": _FINAL_EXP["fq12_mul"] + tree_muls(rows)}
    oracle_gt = rm.Fq12.one()
    for c in pts["want_rows"]:
        oracle_gt = oracle_gt * rm.Fq12.from_coeffs(c)

    # (a) world size 1: an NCCL group of this process alone
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            mesh = pmesh.make_mesh()
            sp, sq = pmesh.shard_points_rns(pts["p"], pts["q"], mesh)
            fn = pmesh.rns_pairing_and_product_sharded(mesh)
            pmesh.reset_collectives()
            (e1, gt1), path_counts["sharded_rns_1"] = drive("sharded_rns_1",
                                                             lambda: fn(sp, sq))
            gathers = pmesh.collectives["all_gather"]
            ms1 = host_times(lambda: fn(sp, sq), 3)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    same_e = torch.equal(e1, pts["multi_pairing"])
    gt_vals = list(tower.decode(gt1[None]))
    same_gt = torch.equal(gt1, pmesh.rns_product_tree(e1))
    print(f"[sharded_rns_1] {backend}, world size 1 on {mesh.device}: e rows identical to "
          f"multi_pairing_1's: {same_e}; gt the oracle's product in both slots: "
          f"{gt_vals == [oracle_gt] * 2}, rows of rns_product_tree(e): {same_gt}; "
          f"{gathers} all_gather per call; {statistics.median(ms1):.1f} ms per call "
          f"(min {min(ms1):.1f}, max {max(ms1):.1f} of 3)")
    assert same_e and gt_vals == [oracle_gt] * 2 and same_gt and gathers == 1
    res["world_size_1"] = {"backend": backend, "ms": ms1, "all_gather": gathers,
                           "launches": {k: v for k, v in path_counts["sharded_rns_1"].items()
                                        if v}}
    mark("sharded pairing, world size 1")

    # (b) two gloo ranks sharing the card (NCCL refuses two ranks on one
    # card), each loading the kernels phase 1 built
    libs = {f: f.stat().st_mtime_ns for f in kernels.build().glob("*.so")}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        ranks = multihost.spawn_ranks(sharded_rank, 2, f"file://{tmp}/rendezvous",
                                      f"cuda:{dev.index or 0}", pts["p_cpu"], pts["q_cpu"],
                                      timeout=300)
        spawn_s = time.perf_counter() - t
    rebuilt = {f: f.stat().st_mtime_ns for f in libs} != libs
    e2 = torch.from_numpy(np.concatenate([r["e"] for r in ranks])).to(dev)
    n_val = int(tower.is_equal(e2, e1).reshape(-1)[:BATCH].sum().item())
    n_rows = elements_equal(e2, e1)
    gt2 = [torch.from_numpy(r["gt"]).to(dev) for r in ranks]
    gt_val = all(bool(tower.is_equal(g, gt1).all()) for g in gt2)
    gt_rows = [torch.equal(g, gt1) for g in gt2]
    want_launches = {k: v for k, v in EXPECTED_LAUNCHES["sharded_rns_1"].items() if v}
    for r in ranks:
        print(f"[sharded_rns_2] rank on {r['device']} ({r['backend']}): launches "
              f"{r['launches']}, {r['all_gather']} all_gather per call, ms per call "
              f"{statistics.median(r['ms']):.1f} (min {min(r['ms']):.1f}, max "
              f"{max(r['ms']):.1f} of 3); jax imported: {r['jax']}")
        assert r["backend"] == "gloo" and r["all_gather"] == 1 and not r["jax"]
        assert r["launches"] == want_launches, (r["launches"], want_launches)
    print(f"[sharded_rns_2] two gloo ranks on one card, {rows // 2} packed rows each "
          f"({spawn_s:.1f} s with the ranks' start): e equal in value to world size 1's "
          f"on {n_val}/{BATCH}, rows identical on {n_rows}/{BATCH}; gt equal in value on "
          f"both ranks: {gt_val}, rows identical: {gt_rows}; kernels rebuilt: {rebuilt}")
    assert n_val == BATCH and gt_val and not rebuilt
    res["world_size_2"] = {"backend": "gloo", "spawn_s": spawn_s, "e_values": n_val,
                           "e_rows_identical": n_rows, "gt_rows_identical": gt_rows,
                           "ranks": [{k: r[k] for k in ("ms", "launches", "all_gather")}
                                     for r in ranks]}
    del e2, gt2, ranks
    mark("sharded pairing, two gloo ranks on one card")

    # (c) the limb tier: the num/den pairing under both strategies, the
    # canonical final exponentiation, each against phase 3's limb pairing
    # and the frozen vectors
    def strategy(name, fn):
        def run():
            lfp.set_strategy(name)
            try:
                return fn()
            finally:
                lfp.set_strategy("auto")
        return run

    lp, lq, lkp, lkq = pts["lp"], pts["lq"], pts["lkp"], pts["lkq"]
    ref, nkat = pts["limb_pairing"], len(pts["kat_chain"])
    for name in ("fused", "auto"):
        run = strategy(name, lambda: lnd.optimized_pairing(lp, lq))
        out, path_counts[f"numden_{name}"] = drive(f"numden_{name}", run)
        n_eq = int(lfq12.is_equal(out, ref).sum().item())
        kout = strategy(name, lambda: lnd.optimized_pairing(lkp, lkq))()
        n_kat = sum(g == w for g, w in zip(lfq12.decode(kout), pts["kat_chain"]))
        ms = host_times(run, 1)[0]
        print(f"[numden_{name}] equal in value to the limb pairing on {n_eq}/{BATCH}, "
              f"KAT e_chain {n_kat}/{nkat}; {ms:.1f} ms per call")
        assert n_eq == BATCH and n_kat == nkat
        res[f"numden_{name}"] = {"ms": ms, "launches": {
            k: v for k, v in path_counts[f"numden_{name}"].items() if v}}
    f = strategy("fused", lambda: lmp.miller_loop(lp, lmp.prepare_g2(lq), lq.infinity))()
    run = strategy("fused", lambda: lmp.final_exponentiation_canonical(f))
    c, path_counts["canonical_fused"] = drive("canonical_fused", run)
    cube = strategy("fused", lambda: lfq12.mul(lfq12.square(c), c))()
    n_eq = int(lfq12.is_equal(cube, ref).sum().item())
    kf = strategy("fused", lambda: lmp.miller_loop(lkp, lmp.prepare_g2(lkq), lkq.infinity))()
    kc = strategy("fused", lambda: lmp.final_exponentiation_canonical(kf))()
    n_kat = sum(g == w for g, w in zip(lfq12.decode(kc), pts["kat_canonical"]))
    ms = host_times(run, 1)[0]
    print(f"[canonical_fused] its cube equal in value to the limb pairing on "
          f"{n_eq}/{BATCH}, KAT e_canonical {n_kat}/{nkat}; {ms:.1f} ms per call")
    assert n_eq == BATCH and n_kat == nkat
    res["canonical_fused"] = {"ms": ms, "launches": {
        k: v for k, v in path_counts["canonical_fused"].items() if v}}
    del f, c, cube, kf, kc
    mark("the limb num/den pairing and canonical final exponentiation")

    # (d) the entry's dry run on this card: one rank, a process of its own
    t = time.perf_counter()
    entry.dryrun_multichip(1)
    res["dryrun_multichip_1_s"] = time.perf_counter() - t
    print(f"[dryrun_multichip] 1 rank on the card: passed in "
          f"{res['dryrun_multichip_1_s']:.1f} s with the rank's start")
    mark("dryrun_multichip(1)")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = -(-BATCH // RC.PACK)
    card = smi()
    kern: dict[str, dict] = {}

    def check(name, got, want, shape_note):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        print(f"[{name}] {shape_note} kernel vs plain: max |diff| {err}")
        assert got.shape == want.shape and err == 0, f"{name} disagrees with its plain version"
        return err

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=os.cpu_count(), mp_context=ctx) as pool:
        ps, qs = points()
        # unrelated points for the small two-term batch (P_5 at infinity
        # among them)
        small = (ps[:SMALL], qs[SMALL:2 * SMALL], ps[2 * SMALL:3 * SMALL],
                 qs[3 * SMALL:4 * SMALL])
        oracle = pool.map(oracle_pairing, ps, qs, chunksize=16)
        oracle_small = pool.map(oracle_multi_pairing, *small, chunksize=1)

        # -- 1. build ------------------------------------------------------
        t = time.perf_counter()
        out_dir = kernels.build()
        print(f"[build] {time.perf_counter() - t:.1f} s into {out_dir}")
        for name, log in kernels.build_log.items():
            for line in log.splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")
        for src in TC_SOURCES + WARP_SOURCES:
            report = ptxas_use(kernels.build_log[src])
            assert report, f"no ptxas report for {src}"
            for entry, use in report.items():
                print(f"[ptxas] {src} {entry}: {use}")
                assert src in SPILL_REPORTED or (
                    " 0 bytes spill stores" in use and " 0 bytes spill loads" in use), (
                    f"{src} {entry} spills")
            if src in WARP_SOURCES:
                continue
            imma = sass_count(out_dir / f"lib{Path(src).stem}.so", "IMMA")
            print(f"[sass] {src}: {imma} IMMA (tensor-core integer products)")
            assert imma > 0, f"{src} runs no tensor-core product"
        print(f"[card] {card}")
        mark("built")

        # -- 2. kernels vs plain at the paths' shapes -------------------------
        rng = np.random.default_rng(2048)
        f_rows = torch.from_numpy(random_fq12_rows(rng, 2 * rows)).to(dev)
        # the easy part of the final exponentiation maps any f to a
        # cyclotomic element, as on the pairing's path
        t0 = tower.mul(tower.conjugate(f_rows), tower.inv(f_rows))
        cyc_in = tower.mul(tower.frobenius_pow(t0, 2), t0).contiguous()
        cyc_err = check("cyc_exp", kernels.cyc_exp(cyc_in, _GS_SEGMENTS),
                        kernels.cyc_exp_plain(cyc_in, _GS_SEGMENTS), tuple(cyc_in.shape))
        cyc_bound = bound_ms(2 * cyc_in.numel() * 4,
                             cyc_exp_ops(RC.PACK * cyc_in.shape[0], _GS_SEGMENTS))
        # and at ragged tile counts (the tensor-core kernels' last tile
        # masked): one row, a partial tile, a whole tile and one more, and
        # the path's rows but for one
        for n in ragged_rows(rows):
            cyc_err = max(cyc_err, check("cyc_exp", kernels.cyc_exp(cyc_in[:n], _GS_SEGMENTS),
                                         kernels.cyc_exp_plain(cyc_in[:n], _GS_SEGMENTS),
                                         f"rows {n}:"))
        kern["cyc_exp"] = {
            "source": "cyc_exp.cu", "replaces": 812, "max_abs_err": cyc_err,
            "ms": time_kernel(lambda i: kernels.cyc_exp(cyc_in, _GS_SEGMENTS), 10),
            "plain_ms": time_host(lambda: kernels.cyc_exp_plain(cyc_in, _GS_SEGMENTS), 2),
            "bound": cyc_bound}

        # the exponentiation's other forms on the same rows: the one-loop
        # kernel (the rows of cyc_exp), a run of 32 squarings in either
        # representation (and the runs of |x| the paths launch), the
        # Karabina chain, the whole Karabina exponentiation (with the
        # identity in a whole row and in one slot: the g2 == 0 branch and a
        # zero norm); the tensor-core kernels also at ragged tile counts
        n_run = 32
        elements = RC.PACK * rows
        numel = cyc_in.numel()
        kara_in = cyc_in.clone()
        kara_in[1] = tower.one((), dev)
        kara_in[2, :, RC.SUB:] = tower.one((), dev)[:, RC.SUB:]
        c_in = tower.compress_cyclotomic(kara_in)
        run_ops = {"cyc_square_run": lambda n: n * tower_op_ops(elements, 12, CYC_SQ_PRODUCTS),
                   "kara_square_run": lambda n: kara_chain_ops(elements, n)}
        exp_cases = {
            "cyc_exp_cond": ("cyc_exp.cu", 674, kernels.cyc_exp_cond,
                             kernels.cyc_exp_cond_plain, (cyc_in, _GS_SEGMENTS),
                             cyc_bound),
            "cyc_square_run": ("cyc_exp.cu", 339, kernels.cyc_square_run,
                               kernels.cyc_square_run_plain, (cyc_in, n_run),
                               bound_ms(2 * numel * 4, run_ops["cyc_square_run"](n_run))),
            "kara_square_run": ("kara_exp.cu", 346, kernels.kara_square_run,
                                kernels.kara_square_run_plain, (c_in, n_run),
                                bound_ms(2 * c_in.numel() * 4,
                                         run_ops["kara_square_run"](n_run))),
            "kara_exp": ("kara_exp.cu", 884, kernels.kara_exp, kernels.kara_exp_plain,
                         (c_in, _KARA_SEGMENTS),
                         bound_ms((1 + len(_KARA_SEGMENTS)) * c_in.numel() * 4,
                                  kara_chain_ops(elements, sum(_KARA_SEGMENTS)))),
            "kara_full": ("kara_full.cu", 649, kernels.kara_full, kernels.kara_full_plain,
                          (kara_in, _KARA_SEGMENTS),
                          bound_ms(2 * numel * 4, kara_full_ops(elements, _KARA_SEGMENTS))),
        }
        for name, (source, line, wrapper, plain, args, bound) in exp_cases.items():
            got = wrapper(*args)
            err = check(name, got, plain(*args), f"{tuple(args[0].shape)}, {args[1]}:")
            if name in RAGGED:
                for n in ragged_rows(rows):
                    cut = (args[0][:n], args[1])
                    err = max(err, check(name, wrapper(*cut), plain(*cut), f"rows {n}:"))
            kern[name] = {
                "source": source, "replaces": line, "max_abs_err": err,
                "ms": time_kernel(lambda i: wrapper(*args), 10),
                "plain_ms": time_host(lambda: plain(*args), 1), "bound": bound}
            if name.endswith("square_run"):
                # the runs of |x| that the "runs" / "karabina_runs" paths
                # launch, each checked and timed (10 queued launches behind a
                # held stream), their sum beside the sum of their bounds
                runs = RUN_LENGTHS[name]
                run_ms, run_bound = [], 0.0
                for n in runs:
                    err = max(err, check(name, wrapper(args[0], n), plain(args[0], n),
                                         f"{tuple(args[0].shape)}, {n}:"))
                    run_ms.append(time_kernel(lambda i, n=n: wrapper(args[0], n), 5, batch=10))
                    run_bound += bound_ms(2 * args[0].numel() * 4, run_ops[name](n))[0]
                print(f"[{name}] the paths' runs {runs}: "
                      + ", ".join(f"{ms:.4f}" for ms in run_ms) + f" ms, sum {sum(run_ms):.4f} "
                      f"ms against a summed bound of {run_bound:.4f} ms")
                kern[name]["max_abs_err"] = err
                kern[name]["extra"] = {"ms_path_runs": sum(run_ms),
                                       "bound_ms_path_runs": run_bound}
            if name == "cyc_exp_cond":
                assert torch.equal(got, kernels.cyc_exp(cyc_in, _GS_SEGMENTS))
            if name == "kara_full":
                same = tower.is_equal(got, kernels.cyc_exp(kara_in, _GS_SEGMENTS))
                assert bool(same.all()) and bool(tower.is_one(got)[1].all())
        del kara_in, c_in, got

        e = rm.P - 2
        vals = [int.from_bytes(rng.bytes(48), "little") % rm.P for _ in range(256)]
        vals[3] = vals[200] = vals[201] = 0
        pow_in = torch.from_numpy(fp.encode(vals)).to(dev)
        got = kernels.pow_static_fused(pow_in, e)
        pow_err = check("pow_static", got, fp.pow_static(pow_in, e),
                        f"{tuple(pow_in.shape)} e=p-2")
        dec = fp.decode(got)
        assert [dec[i] for i in (3, 200, 201)] == [0, 0, 0], "0 must map to 0"
        assert all(v == 0 or dec[i] * v % rm.P == 1 for i, v in enumerate(vals))
        # at odd row counts (a partial last block), and for a short exponent
        for n in ODD_ROWS:
            pow_err = max(pow_err, check("pow_static", kernels.pow_static_fused(pow_in[:n], e),
                                         fp.pow_static(pow_in[:n], e), f"rows {n} e=p-2"))
        pow_err = max(pow_err, check("pow_static", kernels.pow_static_fused(pow_in, 0xD201),
                                     fp.pow_static(pow_in, 0xD201),
                                     f"{tuple(pow_in.shape)} e=0xD201"))
        # the recording build (a witness trace's chains, at the 128-row root
        # of their inverses' product trees): the select form's steps and
        # power
        for n in (pow_in.shape[0], ODD_ROWS[1]):
            rec_out, rec_steps = kernels.pow_static_steps(pow_in[:n], e)
            plain_out, plain_steps = fp.pow_static_steps(pow_in[:n], e)
            pow_err = max(pow_err, check("pow_static", rec_out, plain_out,
                                         f"recording, rows {n} e=p-2"),
                          check("pow_static", rec_steps, plain_steps,
                                f"recording steps {tuple(rec_steps.shape)}"))
            assert torch.equal(rec_out, fp.pow_static(pow_in[:n], e))
        del rec_out, rec_steps, plain_out, plain_steps
        rec_ms = time_kernel(lambda i: kernels.pow_static_steps(pow_in, e), 5, batch=20)
        print(f"[pow_static] recording build: {rec_ms:.4f} ms at {tuple(pow_in.shape)}, "
              f"e=p-2 (a product on every bit, {2 * (e.bit_length() - 1)} steps written)")
        # 20 launches between two events, enqueued while the stream waits:
        # one launch's event pair alone also times the host's enqueue
        pow_ms = time_kernel(lambda i: kernels.pow_static_fused(pow_in, e), 5, batch=20)
        kern["pow_static"] = {
            "source": "pow_static.cu", "replaces": 1035, "max_abs_err": pow_err,
            "ms": pow_ms, "plain_ms": time_host(lambda: fp.pow_static(pow_in, e), 2),
            "bound": bound_ms(2 * pow_in.numel() * 4, pow_ops(256, e))}
        # what the chain of dependent steps costs: one row alone (two warps,
        # no contention) against the latency model
        pow_one = pow_in[:1]
        pow_one_ms = time_kernel(lambda i: kernels.pow_static_fused(pow_one, e), 5, batch=20)
        steps = pow_steps(e)
        print(f"[pow_static] {steps} dependent REDCs: {pow_ms:.4f} ms at "
              f"{tuple(pow_in.shape)}, {pow_one_ms:.4f} ms for one row alone "
              f"({pow_one_ms / steps * 1e3:.4f} us per step, "
              f"{pow_one_ms / steps * 1e-3 * CLOCK_HZ:.0f} cycles at {CLOCK_HZ / 1e9} GHz); "
              f"latency model {steps * POW_STEP_CYC / CLOCK_HZ * 1e3:.4f} ms "
              f"({POW_STEP_CYC} cycles, {POW_STEP_CYC / CLOCK_HZ * 1e6:.4f} us per step)")

        # the five tower ops at (rows, 12, LANES). Each is timed over four
        # copies of its operands in turn (more than the L2 cache holds
        # together), 50 calls between two events.
        g_rows = torch.from_numpy(random_fq12_rows(rng, 2 * rows)).to(dev)
        d_rows = torch.from_numpy(random_fq2_rows(rng, 2 * rows, 6)).to(dev)
        d0, d1, d4 = d_rows[..., 0:2, :], d_rows[..., 2:4, :], d_rows[..., 4:6, :]
        skip_rows = torch.zeros((rows, RC.LANES), dtype=torch.int32, device=dev)
        skip_rows[2, RC.SUB:] = 1
        skip_rows[3, :RC.SUB] = 1
        tower_cases = {
            "fq12_mul": (tower.mul_plain, (f_rows, g_rows), 12, FQ12_MUL_PRODUCTS),
            "fq12_square": (tower.square_plain, (f_rows,), 12, FQ12_SQ_PRODUCTS),
            "fq12_mul_by_014": (tower.mul_by_014_plain, (f_rows, d0, d1, d4), 12,
                                M014_PRODUCTS),
            "fq12_mul_by_014_square": (tower.mul_by_014_square_plain,
                                       (f_rows, d0, d1, d4, skip_rows), 24,
                                       M014_PRODUCTS + FQ12_SQ_PRODUCTS),
            "fq12_cyclotomic_square": (tower.cyclotomic_square_plain, (cyc_in,), 12,
                                       CYC_SQ_PRODUCTS),
        }
        for name, (plain, args, redc_rows, products) in tower_cases.items():
            wrapper = getattr(kernels, name)
            err = check(name, wrapper(*args), plain(*args), tuple(args[0].shape))
            if name == "fq12_mul_by_014_square":  # and without the mask
                err = max(err, check(name, wrapper(*args[:4]), plain(*args[:4]),
                                     "no skip,"))
            for n in ragged_rows(rows):
                # the leading operand's first row broadcast over the n rows
                # (row stride 0), the rest sliced
                part = tuple(x[:n] for x in args)
                bcast = (args[0][:1].expand(n, *args[0].shape[1:]), *part[1:])
                for case, note in ((part, f"rows {n}:"), (bcast, f"rows {n}, stride 0:")):
                    err = max(err, check(name, wrapper(*case), plain(*case), note))
            if name == "fq12_mul":
                # the stacked tail product of the final exponentiation, one
                # operand broadcast (stride 0) as the chain's products with one
                st = torch.stack([f_rows, g_rows, cyc_in, f_rows])
                one4 = tower.one((4, rows), dev)
                err = max(err, check(name, wrapper(st, g_rows), plain(st, g_rows),
                                     f"{tuple(st.shape)} x {tuple(g_rows.shape)}"))
                err = max(err, check(name, wrapper(st, one4), plain(st, one4),
                                     f"{tuple(st.shape)} x one (strides {one4.stride()})"))
            copies = [fresh_operands(args) for _ in range(4)]
            kern[name] = {
                "source": "tower_ops.cu", "replaces": 116, "max_abs_err": err,
                "ms": time_kernel(lambda i: wrapper(*copies[i % 4]), 5, batch=50),
                "plain_ms": time_host(lambda: plain(*args), 3),
                "bound": bound_ms(nbytes(*args) + args[0].numel() * 4,
                                  tower_op_ops(elements, redc_rows, products))}

        # the Miller kernels on the run's own points (two inputs at
        # infinity), at the paths' shapes: prepare_g2_lines and miller_fused
        # on the operands of pairing's fused loop, miller_run with the one
        # term of multi_pairing_1 and the two of pairing_check_2; each also
        # at the ragged row counts
        p_dev = G1Affine.encode(ps, device=dev)
        q_dev = G2Affine.encode(qs, device=dev)
        n_dev = G1Affine.encode([p.neg() for p in ps], device=dev)
        fused = mpr._fused_args(p_dev, q_dev)  # f0, R, Q, py, px, skip, flags
        f0, g2, skip = fused[0], fused[1:6], fused[8]
        assert int(skip.sum().item()) == 2 * RC.SUB

        def ragged(name, wrapper, plain, args, shape_note):
            """Check at the paths' rows and at the ragged counts: the row
            operands cut to n rows (contiguous copies of the step-major
            coefficients), the flags as they are."""
            got = wrapper(*args)
            err = check(name, got, plain(*args), shape_note)
            for n in ragged_rows(rows):
                cut = tuple(
                    [x[:, :n].contiguous() if x.dim() == 5 else x[:n] for x in a]
                    if isinstance(a, list) else a[:n] if torch.is_tensor(a) else a
                    for a in args)
                err = max(err, check(name, wrapper(*cut), plain(*cut), f"rows {n}:"))
            return got, err

        coeffs, err = ragged("prepare_g2_lines", kernels.prepare_g2_lines,
                             kernels.prepare_g2_lines_plain, (*g2, _IS_ADD),
                             f"R, Q {tuple(g2[0].shape)}")
        kern["prepare_g2_lines"] = {
            "source": "miller.cu", "replaces": f"{TPU_PAIRING_RNS}:60", "max_abs_err": err,
            "ms": time_kernel(lambda i: kernels.prepare_g2_lines(*g2, _IS_ADD), 5),
            "plain_ms": time_host(lambda: kernels.prepare_g2_lines_plain(*g2, _IS_ADD), 2),
            "bound": bound_ms(nbytes(*g2) + len(_IS_ADD) * 4 + coeffs.numel() * 4,
                              line_ops(elements, _IS_ADD, False))}
        got, err = ragged("miller_fused", kernels.miller_fused, kernels.miller_fused_plain,
                          fused, f"R, Q {tuple(g2[0].shape)}, f0 strides {f0.stride()}")
        kern["miller_fused"] = {
            "source": "miller.cu", "replaces": f"{TPU_PAIRING_RNS}:413", "max_abs_err": err,
            "ms": time_kernel(lambda i: kernels.miller_fused(*fused), 5),
            "plain_ms": time_host(lambda: kernels.miller_fused_plain(*fused), 2),
            "bound": bound_ms(nbytes(*fused[:9]) + len(fused[9]) * 4 + got.numel() * 4,
                              miller_fused_ops(elements, _IS_ADD, _DO_SQUARE))}
        skip_n = ((n_dev.infinity != 0) | (q_dev.infinity != 0)).to(torch.int32)
        m_args = {t: (f0, [coeffs] * t, [p_dev.y, n_dev.y][:t], [p_dev.x, n_dev.x][:t],
                      [skip, skip_n][:t], _DO_SQUARE) for t in (1, 2)}
        err = 0
        for t, args in m_args.items():
            err = max(err, ragged("miller_run", kernels.miller_run, kernels.miller_run_plain,
                                  args, f"{t} x coeffs {tuple(coeffs.shape)}")[1])
        m_ms = {t: time_kernel(lambda i, a=args: kernels.miller_run(*a), 5)
                for t, args in m_args.items()}
        print(f"[miller_run] {m_ms[1]:.4f} ms with one term, {m_ms[2]:.4f} ms with two")
        kern["miller_run"] = {
            "source": "miller.cu", "replaces": 1008, "max_abs_err": err, "ms": m_ms[1],
            "plain_ms": time_host(lambda: kernels.miller_run_plain(*m_args[1]), 2),
            "bound": bound_ms(nbytes(f0, coeffs, p_dev.y, p_dev.x, skip)
                              + len(_DO_SQUARE) * 4 + got.numel() * 4,
                              miller_ops(elements, _DO_SQUARE))}
        del coeffs, m_args, got, fused, g2

        mark("the RNS tier's kernels held to their plain versions")
        # the limb tier's seven kernels at the shapes its pairing gives them
        # at B = 2048: conv on (2048, 48) component views of Fq12 rows,
        # mont_reduce on the (2048, 12, 95) stack of one fq12.mul with its
        # merged bounds, mont_mul on (2048, 48), the tower kernels on
        # (2048, 12, 48) [and (2048, 6, 48)]. Small kernels are timed over
        # four copies of their operands, 50 calls between two events.
        lfp.set_strategy("auto")
        la = torch.from_numpy(random_limb_rows(rng, BATCH, 12)).to(dev)
        lb = torch.from_numpy(random_limb_rows(rng, BATCH, 12)).to(dev)
        ld = torch.from_numpy(random_limb_rows(rng, BATCH, 6)).to(dev)
        # weakly reduced rows (digits to 258), as the path's products are
        la, lb = lfq12.mul(la, lb), lfq12.square(lb)
        easy = lfq12.mul(lfq12.conjugate(la), lfq12.inv(la))
        lcyc = lfq12.mul(lfq12.frobenius_pow(easy, 2), easy)
        lx, ly = la[:, 3], lb[:, 7]  # (2048, 48), row stride 12 * 48
        def limb_case(name, source, replaces, wrapper, plain, args, out_numel, ops,
                      plain_reps=3, copies=None, odd_rows=False):
            got = wrapper(*args)
            err = check(name, got, plain(*args), tuple(args[0].shape))
            for n in ODD_ROWS if odd_rows else ():
                # n rows, and n rows read in place through a row stride that
                # is not the dense one (slices of a wider stack)
                part = tuple(x[:n] for x in args)
                wide = torch.cat([*part, part[0][:, :5]], dim=-2)
                cuts = [0, *np.cumsum([x.shape[-2] for x in part])]
                views = tuple(wide[:, i:j] for i, j in zip(cuts, cuts[1:]))
                for case, note in ((part, f"rows {n}:"), (views, f"rows {n}, row views:")):
                    err = max(err, check(name, wrapper(*case), plain(*case), note))
            copies = copies or [tuple(x.clone() if torch.is_tensor(x) else x for x in args)
                                for _ in range(4)]
            kern[name] = {
                "source": source, "replaces": replaces, "max_abs_err": err,
                "ms": time_kernel(lambda i: wrapper(*copies[i % 4]), 5, batch=50),
                "plain_ms": time_host(lambda: plain(*args), plain_reps),
                "bound": bound_ms(nbytes(*(x for x in args if torch.is_tensor(x)))
                                  + out_numel * 4, ops)}
            return got

        def check_many(name, gots, wants, note):
            torch.cuda.synchronize()
            assert [g.shape for g in gots] == [w.shape for w in wants]
            err = max(max_abs_err(g, w) for g, w in zip(gots, wants))
            print(f"[{name}] {note} kernel vs plain: max |diff| {err}")
            assert err == 0, f"{name} disagrees with its plain version"
            return err

        # conv at one pair, (2048, 48) component views (row stride 12 * 48),
        # for continuity with earlier runs; the copies are views too
        views = [(la.clone()[:, 3], lb.clone()[:, 7]) for _ in range(4)]
        limb_case("conv", "mont.cu", f"{TPU_LIMB_MONT}:194", lmont.conv, lmont.conv_plain,
                  (lx, ly), BATCH * 95, BATCH * LIMB_CONV_OPS, copies=views)
        # the one PyTorch call that computes conv's function, its yardstick
        # (the port never calls it): a float64 convolution grouped by row,
        # the second operand flipped, padded to the 95 columns, exact below
        # 2^53; on float64 operands made before the timing, four copies
        lib_conv = lambda x, w: torch.nn.functional.conv1d(x, w, padding=LC.NLIMBS - 1,
                                                           groups=w.shape[0])[0]
        lib_ops = [(x.double()[None], y.double().flip(-1)[:, None]) for x, y in views]
        assert torch.equal(lib_conv(*lib_ops[0]).to(torch.int32), lmont.conv(*views[0]))
        one = kern["conv"]
        one["extra"] = {
            "ms_one_pair": one["ms"], "plain_ms_one_pair": one["plain_ms"],
            "bound_ms_one_pair": one["bound"][0],
            "library_ms_one_pair": time_kernel(lambda i: lib_conv(*lib_ops[i % 4]), 5,
                                               batch=50)}
        # and at one cyclotomic squaring's launch, the group the path
        # launches most (30 pairs: component views of the element, their
        # sums), captured from fp.conv_many on four copies of the operand
        conv_many = lfp.conv_many
        groups = []
        lfp.conv_many = lambda pairs: groups.append([p[:2] for p in pairs]) or conv_many(pairs)
        try:
            for x in [lcyc] + [lcyc.clone() for _ in range(3)]:
                lfq12.cyclotomic_square(x)
        finally:
            lfp.conv_many = conv_many
        assert [len(g) for g in groups] == [30] * 4
        g30 = groups[0]
        err = max(one["max_abs_err"], check_many(
            "conv", lmont.conv_many(g30), [lmont.conv_plain(a, b) for a, b in g30],
            f"one cyclotomic squaring's 30 pairs at {BATCH} rows:"))
        for n in ODD_ROWS:
            # the operands' own row views (strides 12 * 48, 2 * 48, 48) cut
            # to n rows, and the first operand's first row broadcast
            part = [(a[:n], b[:n]) for a, b in g30]
            bcast = [(a[:1].expand(n, LC.NLIMBS), b[:n]) for a, b in g30]
            for case, note in ((part, f"30 pairs at {n} rows, row views:"),
                               (bcast, f"30 pairs at {n} rows, stride 0:")):
                err = max(err, check_many("conv", lmont.conv_many(case),
                                          [lmont.conv_plain(a, b) for a, b in case], note))
        operands = {(t.data_ptr(), t.stride()): t for pair in g30 for t in pair}
        lib_ops = [(torch.cat([a.expand(BATCH, -1) for a, _ in g]).double()[None],
                    torch.cat([b.expand(BATCH, -1) for _, b in g]).double().flip(-1)[:, None])
                   for g in groups]
        assert torch.equal(lib_conv(*lib_ops[0]).to(torch.int32),
                           torch.cat(lmont.conv_many(g30)))
        # timed on launches whose arguments are made once: the wrapper's
        # host work for 30 pairs (their row views, the argument struct)
        # would outlast the held stream
        launches = [prepared_conv(g) for g in groups]
        launches[0][0]()
        assert torch.equal(launches[0][1], torch.stack(lmont.conv_many(g30)))
        one.update({
            "max_abs_err": err,
            "ms": time_kernel(lambda i: launches[i % 4][0](), 5, batch=50),
            "plain_ms": time_host(lambda: [lmont.conv_plain(a, b) for a, b in g30], 3),
            "bound": bound_ms(nbytes(*operands.values()) + len(g30) * BATCH * 95 * 4,
                              len(g30) * BATCH * LIMB_CONV_OPS),
            "library_ms": time_kernel(lambda i: lib_conv(*lib_ops[i % 4]), 5, batch=50)})
        del lib_ops, groups, g30, operands, part, bcast, launches
        # a stack of steps against one operand broadcast over them (stride
        # 0, copied by the wrapper), as the coefficient scaling passes it
        steps = la[:, None, 0].expand(BATCH, 5, 48)
        check("conv", lmont.conv(lb[:, :5], steps), lmont.conv_plain(lb[:, :5], steps),
              f"{tuple(lb[:, :5].shape)} x strides {steps.stride()}")
        # the merged 12-output reduction of one fq12.mul
        a0, a1, b0, b1 = lfq12.c0(la), lfq12.c1(la), lfq12.c0(lb), lfq12.c1(lb)
        w0, w1 = lfq6.mul_wide(a0, b0), lfq6.mul_wide(a1, b1)
        w01 = lfq6.mul_wide(lfp.add(a0, a1), lfp.add(b0, b1))
        wides = [w for tri in (lfq6.add_wide(w0, lfq6.mul_by_nonresidue_wide(w1)),
                               lfq6.sub_wide(lfq6.sub_wide(w01, w0), w1))
                 for pair in tri for w in pair]
        stack = torch.stack([w.cols for w in wides], dim=-2)
        r_lo, r_hi = min(w.col_lo for w in wides), max(w.col_hi for w in wides)
        got = limb_case("mont_reduce", "mont.cu", f"{TPU_LIMB_MONT}:215", lmont.mont_reduce,
                        lmont.mont_reduce_plain, (stack, r_lo, r_hi), BATCH * 12 * 48,
                        BATCH * 12 * limb_reduce_ops(lmont.first_pass_count(r_lo, r_hi)))
        assert torch.equal(got, lfq12.mul(la, lb)), "the stack is fq12.mul's"
        # and the 2-element stack of one Fq2 product (fq2.mul, the addition
        # steps', Frobenius maps' and inverse's reductions)
        w2 = lfq2.mul_wide(la[:, 0:2], lb[:, 2:4])
        stack2 = torch.stack([w2[0].cols, w2[1].cols], dim=-2)
        lo2, hi2 = min(w.col_lo for w in w2), max(w.col_hi for w in w2)
        err = max(kern["mont_reduce"]["max_abs_err"], check(
            "mont_reduce", lmont.mont_reduce(stack2, lo2, hi2),
            lmont.mont_reduce_plain(stack2, lo2, hi2), tuple(stack2.shape)))
        assert torch.equal(lmont.mont_reduce(stack2, lo2, hi2),
                           lfq2.mul(la[:, 0:2], lb[:, 2:4])), "the stack is fq2.mul's"
        copies2 = [stack2.clone() for _ in range(4)]
        kern["mont_reduce"]["extra"] = {
            "ms_stack2": time_kernel(lambda i: lmont.mont_reduce(copies2[i % 4], lo2, hi2), 5,
                                     batch=50),
            "bound_ms_stack2": bound_ms(nbytes(stack2) + BATCH * 2 * 48 * 4, BATCH * 2
                                        * limb_reduce_ops(lmont.first_pass_count(lo2, hi2)))[0]}
        for n in ODD_ROWS:
            # n rows, and n rows read in place through a row stride that is
            # not the dense one: one element of the stack (stride 12 * 95)
            # and the stack's first 60 columns (stride 95)
            for case, lo, hi, note in (
                    (stack[:n], r_lo, r_hi, f"rows {n}:"),
                    (stack[:n, 5], r_lo, r_hi, f"rows {n}, one element:"),
                    (stack[:n, :, :60], r_lo, r_hi, f"rows {n}, 60 of 95 columns:"),
                    (stack2[:n], lo2, hi2, f"rows {n}, 2-element stack:")):
                err = max(err, check("mont_reduce", lmont.mont_reduce(case, lo, hi),
                                     lmont.mont_reduce_plain(case, lo, hi), note))
        kern["mont_reduce"]["max_abs_err"] = err
        del copies2, stack2, w2
        got = limb_case("mont_mul", "mont.cu", f"{TPU_LIMB_MONT}:236", lmont.mont_mul,
                        lmont.mont_mul_plain, (lx, ly), BATCH * 48,
                        BATCH * (LIMB_CONV_OPS + limb_reduce_ops(
                            lmont.first_pass_count(0, lmont.MUL_COL_HI))), copies=views)
        wide = lfp.conv(lx, ly)
        same = torch.equal(got, lmont.mont_reduce(wide.cols, wide.col_lo, wide.col_hi))
        print(f"[mont_mul] rows identical to mont_reduce(conv): {same}")
        assert same and wide.col_hi == lmont.MUL_COL_HI
        # at odd row counts: the row views (stride 12 * 48), the first
        # operand's first row broadcast (stride 0), and dense rows
        err = kern["mont_mul"]["max_abs_err"]
        for n in ODD_ROWS:
            for case, note in (((lx[:n], ly[:n]), f"rows {n}, row views:"),
                               ((lx[:1].expand(n, LC.NLIMBS), ly[:n]), f"rows {n}, stride 0:"),
                               ((lx[:n].contiguous(), ly[:n].contiguous()), f"rows {n}:")):
                err = max(err, check("mont_mul", lmont.mont_mul(*case),
                                     lmont.mont_mul_plain(*case), note))
        kern["mont_mul"]["max_abs_err"] = err
        # mont_pow: fp.inv's Fermat chain, p - 2 (608 dependent products), in
        # one launch on (2048, 48) weakly reduced rows (two of them zero),
        # against the loop of mont_mul_plain; at odd row counts on row views
        # too, and for a short exponent
        e = rm.P - 2
        pw, zeros = got.clone(), [3, BATCH - 2]
        pw[zeros] = 0
        pw_got = lmont.mont_pow(pw, e)
        pw_err = check("mont_pow", pw_got, lmont.mont_pow_plain(pw, e),
                       f"{tuple(pw.shape)} e=p-2")
        dec, vals = lfp.decode(pw_got), lfp.decode(pw)
        assert all(dec[i] == 0 for i in zeros), "0 must map to 0"
        assert all(v == 0 or int(d) * int(v) % rm.P == 1 for d, v in zip(dec, vals))
        for n in ODD_ROWS:
            for case, note in ((pw[:n], f"rows {n} e=p-2"),
                               (lx[:n], f"rows {n}, row views e=p-2")):
                pw_err = max(pw_err, check("mont_pow", lmont.mont_pow(case, e),
                                           lmont.mont_pow_plain(case, e), note))
        pw_err = max(pw_err, check("mont_pow", lmont.mont_pow(pw, 0xD201),
                                   lmont.mont_pow_plain(pw, 0xD201),
                                   f"{tuple(pw.shape)} e=0xD201"))
        # an exponent longer than one launch takes: one launch per piece of
        # 32 * POW_WORDS bits, each from the one before's output
        before = lmont.launches["mont_pow"]
        pw_err = max(pw_err, check("mont_pow", lmont.mont_pow(pw, LONG_EXPONENT),
                                   lmont.mont_pow_plain(pw, LONG_EXPONENT),
                                   f"{tuple(pw.shape)} a 600-bit exponent:"))
        pieces = lmont.launches["mont_pow"] - before
        print(f"[mont_pow] a 600-bit exponent in {pieces} launches")
        assert pieces == 2, pieces
        # what it replaces: fp.pow_static's chain as 608 mont_mul launches
        # (made once, called through the bound entry: two chains queued
        # behind a held stream)
        mm_entry, bufs = cuda_build.entry("mont_mul"), [torch.empty_like(pw) for _ in range(2)]

        def mont_mul_chain():
            src, k = pw, 0
            stream = torch.cuda.current_stream().cuda_stream
            for i in range(e.bit_length() - 2, -1, -1):
                for square in (True, False) if (e >> i) & 1 else (True,):
                    dst = bufs[k % 2]
                    y = src if square else pw
                    err = mm_entry(src.data_ptr(), LC.NLIMBS, y.data_ptr(), LC.NLIMBS,
                                   dst.data_ptr(), BATCH, stream)
                    assert err == 0, f"mont_mul launch failed: CUDA error {err}"
                    src, k = dst, k + 1
            return src

        assert torch.equal(mont_mul_chain(), pw_got)
        steps = pow_mont_muls(e)
        pw_ms = time_kernel(lambda i: lmont.mont_pow(pw, e), 5, batch=10)
        pw_one = time_kernel(lambda i: lmont.mont_pow(pw[:1], e), 5, batch=10)
        chain_ms = time_kernel(lambda i: mont_mul_chain(), 3, batch=2)
        print(f"[mont_pow] {steps} dependent products: {pw_ms:.4f} ms at {tuple(pw.shape)} "
              f"({pw_ms / steps * 1e3:.4f} us per step), {pw_one:.4f} ms for one row alone "
              f"({pw_one / steps * 1e3:.4f} us per step); the chain as {steps} mont_mul "
              f"launches {chain_ms:.4f} ms")
        kern["mont_pow"] = {
            "source": "mont.cu", "replaces": f"{TPU_LIMB_FP}:728", "max_abs_err": pw_err,
            "ms": pw_ms, "plain_ms": time_host(lambda: lmont.mont_pow_plain(pw, e), 1),
            "bound": bound_ms(2 * pw.numel() * 4, BATCH * steps * (
                LIMB_CONV_OPS + limb_reduce_ops(lmont.first_pass_count(0, lmont.MUL_COL_HI)))),
            "extra": {"ms_one_row": pw_one, "ms_chain_of_mont_mul": chain_ms}}
        del pw, pw_got, bufs
        for name, line, args in (("mul", 484, (la, lb)), ("square", 489, (la,)),
                                 ("mul_by_014", 494, (la, ld)),
                                 ("cyclotomic_square", 500, (lcyc,))):
            got = limb_case(f"limb_fq12_{name}", "limb_tower.cu", f"{TPU_LIMB_TOWER}:{line}",
                            getattr(ltower, f"fq12_{name}"),
                            getattr(ltower, f"fq12_{name}_plain"), args, BATCH * 12 * 48,
                            limb_tower_ops(BATCH, name), plain_reps=2, odd_rows=True)
            # equal in value to the composition path (other rows)
            composed = {"mul": lfq12.mul, "square": lfq12.square,
                        "cyclotomic_square": lfq12.cyclotomic_square}.get(name)
            if composed is not None:
                assert bool(lfq12.is_equal(got, composed(*args)).all()), name
            assert int(got.max()) <= LC.SEMI_DIG and int(got.min()) >= 0
        del la, lb, ld, lcyc, easy, stack, wides, w0, w1, w01, got, steps, views
        torch.cuda.empty_cache()
        mark("the limb tier's kernels held to their plain versions")
        for name, k in kern.items():
            extra = "" if k["bound"][2] is None else f" [int32 only {k['bound'][2]:.4f}]"
            extra += f", library {k['library_ms']:.4f} ms" if "library_ms" in k else ""
            extra += "".join(f", {key} {v:.4f}" for key, v in k.get("extra", {}).items())
            print(f"[{name}] {k['ms']:.4f} ms, plain {k['plain_ms']:.2f} ms, bound "
                  f"{k['bound'][0]:.4f} ms by {k['bound'][1]}{extra}")

        # -- 3. the paths, end to end ----------------------------------------
        # (a) pairing: fused prepare + Miller loop
        path_counts = {}
        out, path_counts["pairing"] = drive("pairing", lambda: mpr.pairing(p_dev, q_dev))
        assert out.shape == (rows, 12, RC.LANES) and out.dtype == torch.int32

        got_rows = fp.decode(out)[:BATCH]
        want_rows = list(oracle)
        bad = [i for i in range(BATCH) if list(got_rows[i]) != want_rows[i]]
        print(f"[pairing] vs oracle: {BATCH - len(bad)}/{BATCH} bit-exact")
        assert not bad, f"pairing disagrees with the oracle at {bad[:8]}"

        kat = json.loads(KAT.read_text())["vectors"]
        kp = [rm.G1Affine(int(v["p_x"], 16), int(v["p_y"], 16), False) for v in kat]
        kq = [rm.G2Affine(rm.Fq2(int(v["q_x"][0], 16), int(v["q_x"][1], 16)),
                          rm.Fq2(int(v["q_y"][0], 16), int(v["q_y"][1], 16)), False)
              for v in kat]
        kout = mpr.pairing(G1Affine.encode(kp, device=dev), G2Affine.encode(kq, device=dev))
        kgot = list(tower.decode(kout))[: len(kat)]
        kwant = [rm.Fq12.from_coeffs([int(h, 16) for h in v["e_chain"]]) for v in kat]
        nkat = sum(g == w for g, w in zip(kgot, kwant))
        print(f"[pairing] KAT e_chain: {nkat}/{len(kat)}")
        assert nkat == len(kat)

        # (b) multi_pairing with one term: split prepare, the miller_run
        # kernel; the same rows as pairing, hence the oracle's values
        out1, path_counts["multi_pairing_1"] = drive(
            "multi_pairing_1", lambda: mpr.multi_pairing([p_dev], [q_dev]))
        same = torch.equal(out1, out)
        print(f"[multi_pairing_1] rows identical to pairing's: {same}")
        assert same, "single-term multi_pairing and pairing give different rows"

        # (c) pairing_check with two terms of B points each
        ok, path_counts["pairing_check_2"] = drive(
            "pairing_check_2", lambda: mpr.pairing_check([p_dev, n_dev], [q_dev, q_dev]))
        ok = ok.reshape(-1)[:BATCH].cpu().numpy()
        print(f"[pairing_check_2] e(P,Q) e(-P,Q) == 1 on {int(ok.sum())}/{BATCH}")
        assert ok.all()
        ok2 = mpr.pairing_check([p_dev, p_dev], [q_dev, q_dev])
        ok2 = ok2.reshape(-1)[:BATCH].cpu().numpy()
        print(f"[pairing_check_2] e(P,Q)^2 == 1 only at {np.flatnonzero(ok2).tolist()}")
        assert np.flatnonzero(ok2).tolist() == [5, 6]

        sp0, sq0, sp1, sq1 = small
        m2 = mpr.multi_pairing(
            [G1Affine.encode(sp0, device=dev), G1Affine.encode(sp1, device=dev)],
            [G2Affine.encode(sq0, device=dev), G2Affine.encode(sq1, device=dev)])
        got_small = fp.decode(m2)[:SMALL]
        want_small = list(oracle_small)
        nsmall = sum(list(got_small[i]) == want_small[i] for i in range(SMALL))
        print(f"[multi_pairing_2] B={SMALL} unrelated points vs oracle: "
              f"{nsmall}/{SMALL} bit-exact")
        assert nsmall == SMALL

        # (d) the Karabina final exponentiation: pairing under
        # impl="karabina" against the same oracle values and vectors
        outk, path_counts["pairing_karabina"] = drive(
            "pairing_karabina", lambda: mpr.pairing(p_dev, q_dev, impl="karabina"))
        got_rows = fp.decode(outk)[:BATCH]
        bad = [i for i in range(BATCH) if list(got_rows[i]) != want_rows[i]]
        print(f"[pairing_karabina] vs oracle: {BATCH - len(bad)}/{BATCH} bit-exact")
        assert not bad, f"pairing(impl='karabina') disagrees with the oracle at {bad[:8]}"
        kout = mpr.pairing(G1Affine.encode(kp, device=dev), G2Affine.encode(kq, device=dev),
                           impl="karabina")
        nkat = sum(g == w for g, w in zip(list(tower.decode(kout))[: len(kat)], kwant))
        print(f"[pairing_karabina] KAT e_chain: {nkat}/{len(kat)}")
        assert nkat == len(kat)

        # and each form of the exponentiation on that batch's Miller-loop
        # output (elements 5 and 6 are one: the g2 == 0 branch)
        f_miller = mpr.miller_loop_fused(p_dev, q_dev)
        ones = tower.is_one(f_miller).reshape(-1)[:BATCH].nonzero().flatten().tolist()
        assert ones == [5, 6]
        exp_runs = {f"final_exp_{impl}":
                    (lambda impl=impl: mpr.final_exponentiation(f_miller, impl=impl))
                    for impl in mpr.EXP_IMPLS}
        ref = None
        for impl in mpr.EXP_IMPLS:
            name = f"final_exp_{impl}"
            got, path_counts[name] = drive(name, exp_runs[name])
            ref = got if ref is None else ref
            n_eq = int(tower.is_equal(got, ref).reshape(-1)[:BATCH].sum().item())
            rows_same = torch.equal(got, ref)
            print(f"[{name}] equal in value to final_exp_segments on {n_eq}/{BATCH}, "
                  f"rows identical: {rows_same}")
            assert n_eq == BATCH
            assert rows_same or impl not in ("cond", "runs")
        assert torch.equal(ref, out), "final_exponentiation(miller_loop_fused) is pairing"
        del ref, got

        mark("the RNS tier's paths driven")
        # (e) the limb tier's pairing on the same points, under both
        # strategies, against the oracle values computed for (a)
        lp_dev = lcurve.G1Affine.encode(ps, device=dev)
        lq_dev = lcurve.G2Affine.encode(qs, device=dev)
        lkp = lcurve.G1Affine.encode(kp, device=dev)
        lkq = lcurve.G2Affine.encode(kq, device=dev)

        def limb_run(strategy, fn):
            def run():
                lfp.set_strategy(strategy)
                try:
                    return fn()
                finally:
                    lfp.set_strategy("auto")
            return run

        limb_runs = {f"limb_pairing_{strategy}":
                     limb_run(strategy, lambda: lmp.pairing(lp_dev, lq_dev))
                     for strategy in ("auto", "fused")}
        limb_out = {}
        for name, run in limb_runs.items():
            limb_out[name], path_counts[name] = drive(name, run)
            assert limb_out[name].shape == (BATCH, 12, LC.NLIMBS)
            assert limb_out[name].dtype == torch.int32
            got_rows = lfp.decode(limb_out[name])
            bad = [i for i in range(BATCH) if list(got_rows[i]) != want_rows[i]]
            print(f"[{name}] vs oracle: {BATCH - len(bad)}/{BATCH} bit-exact")
            assert not bad, f"{name} disagrees with the oracle at {bad[:8]}"
            kout = limb_run(name.rsplit("_", 1)[1], lambda: lmp.pairing(lkp, lkq))()
            nkat = sum(g == w for g, w in zip(list(lfq12.decode(kout)), kwant))
            print(f"[{name}] KAT e_chain: {nkat}/{len(kat)}")
            assert nkat == len(kat)
        n_eq = int(lfq12.is_equal(*limb_out.values()).sum().item())
        print(f"[limb_pairing] auto and fused equal in value on {n_eq}/{BATCH}, rows "
              f"identical: {torch.equal(*limb_out.values())}")
        assert n_eq == BATCH
        limb_ref = limb_out["limb_pairing_fused"]
        del limb_out

        ln_dev = lp_dev.neg()
        name = "limb_pairing_check_2_fused"
        limb_runs[name] = limb_run("fused", lambda: lmp.pairing_check(
            [lp_dev, ln_dev], [lq_dev, lq_dev]))
        ok, path_counts[name] = drive(name, limb_runs[name])
        ok = ok.cpu().numpy()
        print(f"[{name}] e(P,Q) e(-P,Q) == 1 on {int(ok.sum())}/{BATCH}")
        assert ok.shape == (BATCH,) and ok.all()
        ok2 = limb_run("fused", lambda: lmp.pairing_check(
            [lp_dev, lp_dev], [lq_dev, lq_dev]))().cpu().numpy()
        print(f"[{name}] e(P,Q)^2 == 1 only at {np.flatnonzero(ok2).tolist()}")
        assert np.flatnonzero(ok2).tolist() == [5, 6]

        mark("the limb tier's paths driven")
        runs = {
            "pairing": lambda: mpr.pairing(p_dev, q_dev),
            "multi_pairing_1": lambda: mpr.multi_pairing([p_dev], [q_dev]),
            "pairing_check_2": lambda: mpr.pairing_check([p_dev, n_dev], [q_dev, q_dev]),
            "pairing_karabina": lambda: mpr.pairing(p_dev, q_dev, impl="karabina"),
            **exp_runs,
            **limb_runs,
        }
        timed = {name: time_path(name, run, card) for name, run in runs.items()}
        mark("paths timed")

        # -- 4. where the time goes ------------------------------------------
        for name, run in runs.items():
            timed[name].update(profile_call(name, run, host_ops=name not in limb_runs))
            mark(f"profiled {name}")
        t = timed["pairing"]
        print(json.dumps({"pairing": {**t, "pairings_per_s": t["per_s"]}}))
        print(json.dumps({"pairing_split": {
            "multi_pairing_1": timed["multi_pairing_1"],
            "pairing_check_2": timed["pairing_check_2"]}}))
        print(json.dumps({"pairing_karabina": timed["pairing_karabina"]}))
        for impl in mpr.EXP_IMPLS:
            name = f"final_exp_{impl}"
            print(json.dumps({name: {**timed[name], "launches": {
                k: v for k, v in path_counts[name].items() if v}}}))
        for name in limb_runs:
            print(json.dumps({name: {**timed[name], "launches": {
                k: v for k, v in path_counts[name].items() if v}}}))

        # -- 5. the whole call captured into a CUDA graph --------------------
        # Captured from entry-style inputs (the generators at every element),
        # replayed on set 1 (the run's points) and set 2 (the frozen
        # vectors' points, then the run's from ROLL on)
        g1, g2 = rm.G1Affine.generator(), rm.G2Affine.generator()
        idx = [(ROLL + i) % BATCH for i in range(BATCH - len(kp))]
        ps_b, qs_b = kp + [ps[i] for i in idx], kq + [qs[i] for i in idx]
        want_b = [w.coeffs() for w in kwant] + [want_rows[i] for i in idx]
        inf_b = [j for j in range(BATCH) if ps_b[j].infinity or qs_b[j].infinity]
        want_sets = (want_rows, want_b)
        inf_sets = ([5, 6], inf_b)
        p_gen, q_gen = G1Affine.generator((BATCH,), dev), G2Affine.generator((BATCH,), dev)
        n_gen = G1Affine.encode([g1.neg()] * BATCH, device=dev)
        p_b, q_b = G1Affine.encode(ps_b, device=dev), G2Affine.encode(qs_b, device=dev)
        n_b = G1Affine.encode([p.neg() for p in ps_b], device=dev)
        lp_b, lq_b = lcurve.G1Affine.encode(ps_b, device=dev), lcurve.G2Affine.encode(qs_b,
                                                                                    device=dev)

        def oracle_check(name, decode):
            def verify(k, got):
                rows_ = decode(got)[:BATCH]
                same = [list(rows_[i]) == want_sets[k][i] for i in range(BATCH)]
                note = f", KAT e_chain {sum(same[:len(kp)])}/{len(kp)}" if k == 1 else ""
                print(f"[capture {name}] input set {k + 1}: replay vs oracle "
                      f"{sum(same)}/{BATCH}{note}")
                assert all(same), (name, k)
            return verify

        def check_true(name, where):
            def verify(k, got):
                ok = got.reshape(-1)[:BATCH].cpu().numpy()
                want = list(range(BATCH)) if where is None else inf_sets[k]
                print(f"[capture {name}] input set {k + 1}: true at {int(ok.sum())}/{BATCH}"
                      f" elements, as expected: {np.flatnonzero(ok).tolist() == want}")
                assert np.flatnonzero(ok).tolist() == want, (name, k)
            return verify

        def limb_fused_pairing(p, q):
            lfp.set_strategy("fused")
            try:
                return lmp.pairing(p, q)
            finally:
                lfp.set_strategy("auto")

        capture_paths = {
            "pairing": (mpr.pairing, (p_gen, q_gen), [(p_dev, q_dev), (p_b, q_b)],
                        oracle_check("pairing", fp.decode)),
            "multi_pairing_1": (mpr.multi_pairing, ([p_gen], [q_gen]),
                                [([p_dev], [q_dev]), ([p_b], [q_b])],
                                oracle_check("multi_pairing_1", fp.decode)),
            "pairing_check_2": (mpr.pairing_check, ([p_gen, n_gen], [q_gen, q_gen]),
                                [([p_dev, n_dev], [q_dev, q_dev]), ([p_b, n_b], [q_b, q_b])],
                                check_true("pairing_check_2", None)),
            "pairing_check_2_same": (
                mpr.pairing_check, ([p_gen, p_gen], [q_gen, q_gen]),
                [([p_dev, p_dev], [q_dev, q_dev]), ([p_b, p_b], [q_b, q_b])],
                check_true("pairing_check_2_same", "infinity")),
            "limb_pairing_fused": (
                limb_fused_pairing, (lcurve.G1Affine.generator((BATCH,), dev),
                                     lcurve.G2Affine.generator((BATCH,), dev)),
                [(lp_dev, lq_dev), (lp_b, lq_b)],
                oracle_check("limb_pairing_fused", lfp.decode)),
        }
        captured = capture_phase(card, capture_paths)
        print(json.dumps({"capture": captured}))

        # -- 6. the witness trace and checkpoint/resume ----------------------
        wres = witness_phase(card, drive, path_counts, {
            "p": p_dev, "q": q_dev, "lp": lp_dev, "lq": lq_dev, "pairing": out,
            "karabina": outk, "want_rows": want_rows})
        print(json.dumps({"witness": wres}))

        # -- 7. data-parallel sharding, the num/den loop, the canonical
        # final exponentiation ---------------------------------------------
        sres = sharding_phase(card, drive, path_counts, {
            "p": p_dev, "q": q_dev, "p_cpu": G1Affine.encode(ps, device="cpu"),
            "q_cpu": G2Affine.encode(qs, device="cpu"), "multi_pairing": out1,
            "want_rows": want_rows, "lp": lp_dev, "lq": lq_dev, "lkp": lkp, "lkq": lkq,
            "limb_pairing": limb_ref, "kat_chain": kwant,
            "kat_canonical": [rm.Fq12.from_coeffs([int(h, 16) for h in v["e_canonical"]])
                              for v in kat]})
        print(json.dumps({"sharding": sres}))

    all_kernels = cuda_build.all_launches()
    for name in all_kernels:
        launched = sum(c[name] for c in path_counts.values())
        assert launched == 0 if name in OFF_PATH else launched > 0, (name, launched)
    order = ["cyc_exp", "cyc_exp_cond", "cyc_square_run", "kara_square_run", "kara_exp",
             "kara_full", "pow_static", "miller_run", "miller_fused", "prepare_g2_lines",
             "fq12_mul", "fq12_square",
             "fq12_mul_by_014", "fq12_mul_by_014_square", "fq12_cyclotomic_square",
             "conv", "mont_reduce", "mont_mul", "mont_pow", "limb_fq12_mul",
             "limb_fq12_square", "limb_fq12_mul_by_014", "limb_fq12_cyclotomic_square"]
    assert sorted(order) == sorted(kern) == sorted(all_kernels)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{PORT_CSRC}/{kern[name]['source']}",
         "replaces": (kern[name]["replaces"] if isinstance(kern[name]["replaces"], str)
                      else f"{TPU_KERNELS}:{kern[name]['replaces']}"),
         "launches": sum(c[name] for c in path_counts.values()),
         "launches_by_path": {p: c[name] for p, c in path_counts.items()},
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound"][0],
         "bound_by": kern[name]["bound"][1],
         # the RNS kernels' bound with the base extensions at the int32 rate
         **({"bound_int32_ms": kern[name]["bound"][2]}
            if kern[name]["bound"][2] is not None else {}),
         "library_ms": kern[name].get("library_ms"),
         # conv at one pair beside its 30-pair launch; mont_reduce at a
         # 2-element stack beside the 12-element one
         **kern[name].get("extra", {})}
        for name in order]}
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
