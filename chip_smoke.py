#!/usr/bin/env python3
"""Drive the kzg_torch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device: the card's name and power limit (nvidia-smi).
2. build: every kernel of kzg_torch/csrc, compiled with nvcc (one process per
   source, in parallel) into build/kzg_torch_kernels/; each kernel's
   registers a thread, spills and shared memory from -Xptxas -v.
3. kernels: each kernel against its plain PyTorch version on the card on
   seeded inputs with the exceptional cases (the multiply on every pair of
   p - 1, 0, 1 and R mod p; P == Q, P == -Q and infinity lanes, an odd
   C < 64 streaming scan with a P == Q step, every K4 mode; for the fused
   scan digit 0, absent digits, a run across chunks, a chunk of one digit
   and P == Q / P == -Q at a chunk's start, also against the streaming path
   it replaced; for the window fold the case table of
   kzg_torch/utils/fold_cases.py: a zero digit in every window position,
   an all-zero scalar, k = r - 1 and lanes whose partial sum equals their
   next table entry, so that the exact madd doubles, one of them alone in
   its warp and three in another; the doubling chain at
   1, 5 and 16 steps and in windows; the batched inversion in both fields at
   n = 1, 2, a partial run in a partial block, all-zero input, zeros at run
   and block boundaries and the values 1, p - 1 and R mod p, where every
   non-zero lane times its inverse must be Montgomery one; K4 at W = 32, 257,
   a partial run in a partial segment over R > 1 rows, and the commit's
   131,072, in all four modes); the expected result is bit-identical output.
4. paths, each driven through the entry points with the launch counts set to
   0 just before and read just after, every call of a kernel wrapper logged
   with its shapes, and the host time spent in Python's garbage collector
   during the run added up (gc.callbacks; the set-up's objects, among them
   the oracles' 2^20-element lists, are frozen out of it first):
   - ceremony: genmul.chunked_srs_g1(s, 2^20, chunk=2^16), the G1
     powers-of-tau (generator tables, then the window fold per chunk). Its
     SRS must equal, on every one of the 2^20 lanes, the one the port's
     double-and-add ladder and to_affine make (set-up, not counted), and the
     host oracle s^i G1 on spot lanes.
   - main: the fixed-base commit at n = 2^20 against the ceremony's SRS:
     DeviceSRS.fixed_tables() and the first Polynomial.commit. The table
     build must launch the windowed doubling chain once, no 2^20-lane
     g1_double and at most MAX_FP_MULS_TABLES Fp multiplies (its inversion
     is the inversion kernel's three launches); the commit the fused scan
     and not the streaming one, the bucket reduction once, K4 4 times and
     K2's add and double never (COMMIT_LAUNCHES). The ceremony
     may launch at most MAX_FP_MULS_CEREMONY Fp multiplies.
   - proof: Polynomial.evaluate at a seeded x and Evaluation.generate_proof
     (sub, divide_by_root, the quotient's commit against the same tables).
     y must equal the host's Horner value P(x), and the proof
     ((P(s) - y) / (s - x) mod r) G1, in the first run and in 3 warm runs.
     The evaluation and the division must run their kernels, and the path
     at most MAX_FR_MULS_PROOF Fr multiplies; its one commit launches as the
     main path's does (COMMIT_LAUNCHES).
   - batched: the commit below FIXED_BASE_THRESHOLD (n = 8192), which runs
     the batched double-and-add MSM: one K2b launch (ladder_msm) and no K2
     double, madd or add (BATCHED_LAUNCHES, per MSM).
   - reference size: the commit and the opening proof of a 10-coefficient
     polynomial (the reference CLI's degree 9) against the 2^20 SRS, whose
     first 10 points the commit takes; two MSMs, each one K2b launch and no
     K2 launch. The proof must equal the host oracle as the 2^20 one does.
   - setup, after those paths (phase_setup): (a) the reference CLI's
     trusted-setup, generate_setup of 10 points from tests/golden/setup.json's
     secret with no generator tables (one launch of each group's generator
     ladder, Mode B, and none of K2's or K9's formulas: SETUP_REF_LAUNCHES),
     its bytes and
     SetupArtifactsGenerator's first 10 items' those of the golden file and
     of hostmath; (b) generate_setup of 2^16 points (the tables built in
     the run): G1 equal to chunked_srs_g1's words and G2 by K9 to the plain
     route on the card (tables and fold on fp2's plain operations) on every
     lane, G2 to hostmath's s^k G2 on 64 lanes, the first and last among
     them; (c) save_setup, then load_setup through the two device batches
     with the subgroup checks ([r] P, one Mode A ladder launch a group:
     LOAD_LAUNCHES): the same bytes back, an off-subgroup G2 point, an
     off-curve G1 point and x >= p
     rejected with kzg_tpu's messages, and DeviceSRS.load's words those of
     DeviceSRS.from_artifacts; (d) the 2^20 ceremony's points compressed,
     then g1_decompress_batch with the subgroup check (one G1 Mode A launch:
     DECOMPRESS_LAUNCHES): the ceremony's words.
   - verify, after the setup paths and with the generator tables set aside
     (a verifier's process has none; phase_verify): Evaluation.verify_proof
     of the main path's C and the proof path's pi, x and y against the 2^20
     SRS (s G2 from hostmath, set-up): True first and in 3 warm runs, False
     for a wrong y, pi + G1 and C + G1; K10 and K11 once, the x G2 and y G1
     generator ladders (Mode B) one launch each and one add of each group,
     no other K2 or K9
     launch (VERIFY_LAUNCHES, verify_proofs_batch 64 too). Then the
     10-coefficient proof against a list of 10
     SetupArtifact, verify_proofs_batch at V = 1, 16 and 64 on openings of
     that polynomial with item 7 given a wrong y (V = 64 a driven path),
     and bilinear_map against hostmath.pairing on two seeded pairs, its
     bilinearity and its infinity lanes.
   Each commit must equal the host oracle (sum a_i s^i mod r) G1, and each
   kernel of a path must have launched in its run.
5. replay: every logged call again at its shapes on seeded inputs, kernel
   against plain version (bit-identical), then timed by CUDA events. A
   kernel's ms, plain_ms and bound are sums over the calls its path made.
   The ladder calls first (phase_ladders): each launched and timed, then
   both groups' ladder kernels in both modes on the case tables of
   kzg_torch/utils/mul_cases.py at n = 1, 9, 127, 128, 129 and 2^16: Mode A
   (the signed-digit ladder) one scalar a lane (k = 0, 1, r - 1,
   2^256 - 1, r, r + 2, r - 2, SPLIT_DOUBLE, and r - 2 on three lanes of
   one warp) and [r] P (a subgroup point, infinity, a point outside the
   subgroup, G1's point of order 3, which meets acc == P, acc == -P and
   infinity, or G2's off-subgroup point negated); Mode B (the generator's
   scalar split into pieces, a thread a piece) on the same scalars, not
   reduced, and seeded ones; the case lanes against the host oracles by
   group element. Every
   one of these calls is held to its mode's plain version on all its lanes
   up to 512 and on its first and last 256 beyond, the plain version run
   once a group and mode over all their checked lanes side by side (its
   plain_ms each replayed call's).
   The kernels no path launches are checked and timed at fixed shapes: the
   streaming scan in both modes at the shape the fused scan ran on the main
   path (m steps over C chunks), the fold over pre-gathered entries (K8) at
   the ceremony's fold shape, and the doubling chain (K7) at 2^16 lanes and
   16 steps; and the field multiply's probes, K1 at 2^24 Fp lanes and K2's
   doubling at 2^20 lanes (the shapes every checkout's table build has run,
   so that two checkouts' runs compare field.cuh). K2's double and add,
   which no path launches since K2b, at the batched commit's shapes: the
   route K2b replaced (256 doubles and 256 exact madds of 8192 lanes, adds
   of 4096, 2048, .., 1 lanes), each checked and timed, and K9's doubling
   at 2^16 lanes (the ladders took it off every path)
   (scripts/batched_commit_probe.py times that whole route against K2b).
   Then the stage times of the ceremony and of the proof.
6. profile: one warm 2^20 commit under torch.profiler, device time by kernel;
   the commit's index gathers must take less than one 805 MB table gather
   would at the card's memory rate (the scan reads its own table points).
7. the proof's evaluation and division at n = 1, 2, a run's length minus
   and plus one, a tile, a tile and one and two, and 128 tiles and five,
   each at x = 0, 1, r - 1 and a seeded point, against both plain versions;
   the division of a polynomial with a known root equal to its other
   factor, and a non-root raising ProtocolError; bit-identical output
   expected. Then the bucket reduction (stages 6-7 of the commit's MSM) on
   every case of kzg_torch/utils/reduce_cases.py (every bucket empty, only
   S_top, only b = 0, only b = 2^15 - 1, equal leaves (the add doubles), P
   and -P meeting at a block-tree level and in the last block's tree
   (infinity)) and on seeded words at the commit's chunk count, each
   against its plain version and that route replayed on K2's add
   (bit-identical), the cases also against the host oracle (sum_b b k_b) G1.
   Then K2b at the paths' n = 10 and 8192 and at 129 (a partial block) on
   the exceptional lanes of kzg_torch/utils/ladder_cases.py (scalars 0, 1, r - 1, 2^256 - 1,
   2^255 + k, r + 2 and r, P and -P, equal lanes, two lanes flagged
   infinite; unmasked too), each against msm_batched_plain, that route on
   K2's kernels (bit-identical) and the host oracle. The other sizes (1, 2,
   127, 128, 16383, 65536) are tests/test_torch_gpu.py's. Then K9 on the
   case table of kzg_torch/utils/g2_cases.py at n = 1, 127, 128 and 129,
   against its plain version (bit-identical) and the case lanes against
   the host oracle. Then K10 and K11 at n = 1, 2, 33 and 128 lanes (the
   generator pair, an infinity lane of zero words, seeded pairs; K11 also
   on a lane of random Fp12 words) against their plain versions, each run
   once over all sizes' lanes side by side, and the generator pair's
   pairing against hostmath.
   All after every timing: run before the paths, such checks' allocations
   moved the buffers the later paths allocate, and the window fold (K5)
   read slower for it.
8. a line {"kernels": [...]} (the bucket reduction's and K2b's entries also
   give their critical paths, BUCKET_REDUCE_CHAIN and ladder_chain, and the
   ms per point operation on them; the ladder kernels' each path's call,
   its chain (mul_chain, gen_chain) and us per point operation; K10's and
   K11's their chains of Fp12
   operations, PAIRING_CHAINS, and their numbers at the batch of 64), then
   the last line {"ok": true,
   "device": ...}.

Bounds: the larger of bytes moved / 3.35 TB/s (H100 SXM HBM3) and 32-bit
integer multiply-adds / 16.7 T/s (132 SMs x 64 IMAD per clock x 1.98 GHz, the
H100 SXM boost clock; CUDA C++ Programming Guide, arithmetic instruction
throughput for compute capability 9.0). A 32x32->64 multiply-add counts as
two 32-bit multiply-adds, so an Fp Montgomery multiply (12 words, CIOS) is
2 * (2 * 12^2 + 12) = 600 and an Fr one 2 * (2 * 8^2 + 8) = 272. An Fp
square needs only the 78 distinct word products a_i a_k (i <= k) before the
12 reduction rows: 2 * (78 + 12^2 + 12) = 468. The point formulas are counted
in their cheapest published forms (M an Fp multiply, S a square): a point
add 11M + 5S (add-2007-bl) = 8,940, a mixed add 7M + 4S (madd-2007-bl) =
6,072, a doubling 2M + 5S (dbl-2009-l) = 3,540. Over Fp2 (G2, K9) an M is
Karatsuba with lazy reduction (as blst's mul_mont_384x): three 12x12-word
products and two Montgomery reductions, 2 * (3 * 12^2 + 2 * (12^2 + 12)) =
1,488; an S is the complex square, two full Fp multiplies (1,200). So a G2
add is 22,368, a mixed add 15,216 and a doubling 8,976, and each moves 96
bytes a coordinate. A prefix sum of W points
needs W - 1 adds (W - 2 when exclusive), whatever order a kernel adds in; a
fold needs one mixed add per non-zero entry after a lane's first (the first
is a copy), counted on the inputs of the run. The fused scan over P pairs in
C chunks needs P - C mixed adds (a chunk's first is a copy) and moves 96 P
bytes of table rows, 8 P of keys and digits, and 3 * 48 (C + 2^15 + 1) of
totals and bucket slots; the windowed chain over n lanes needs
(first + steps (windows - 1)) doublings a lane and moves 96 n bytes in and
144 n a window out. The batched inversion of n lanes needs 3 (n - 1)
multiplies (Montgomery's trick) and one Fermat ladder x^(N - 2) in fixed
4-bit windows (380 squares and 105 multiplies for Fp, 252 and 73 for Fr,
each Fr square a multiply), and moves 2 * 4L n bytes. The proof's
evaluation of n coefficients needs n - 1 Fr multiplies (Horner) and reads
32 n bytes: at n = 2^20, (2^20 - 1) * 272 / 16.7e12 s = 0.0171 ms of
operations against 2^25 / 3.35e12 s = 0.0100 ms of bytes, so 0.0171 ms. Its
division needs at least n - 2 (the recurrence's n - 1 steps, the first a
copy), reads 32 n bytes and writes 32 (n - 1): at 2^20, 0.0171 ms of
operations against (2^26 - 32) / 3.35e12 s = 0.0200 ms of bytes, so
0.0200 ms. The bucket reduction (reduce_cost) of 2^15 + 1 buckets needs,
since sum_b b S_b = 2^15 V_top - sum_(b < 2^15) V_b, an add for each valid
V_b, 2^15 - 1 adds for the sum, one subtraction and 15 doublings: at most
65,537 adds, 0.0350 ms of operations, against 23.9 MB read at the commit's
C = 2^17 (0.0071 ms), whatever route its kernel takes. The batched MSM
(ladder_cost) needs, on the inputs of the run's lanes not flagged and with
k_i != 0, the fewer operations of two methods: the lanes' own ladders
(bitlen(k_i) - 1 doublings and popcount(k_i) - 1 mixed adds a lane, the
first set bit a copy, then one add fewer than such lanes), or the bucket
method (bucket_ops) at its best window c: for each c-bit window, a mixed
add for each non-zero digit but a bucket's first, the running sum over the
buckets from the highest digit down, and c doublings and an add a window
below the top one. At the batched path's 8192 random scalars the buckets
win (about 0.095 ms, at c = 10); at a lane or two, the ladder. It reads 128
bytes a lane (a mask byte more) and writes one point. A scalar
multiplication on any base (mul_cost; Mode A of the ladder kernels) needs,
on a live lane with k != 0, the cheapest of three ladders on k (not
reduced: the base may lie outside the subgroup): binary (bitlen(k) - 1
doublings, popcount(k) - 1 mixed adds), a fixed 4-bit window (bitlen(k) - 1
doublings; a 14-point table, then an add a non-zero window below the top
one) and the NAF (its top digit's index in doublings, weight - 1 mixed
adds): [r] P 255 doublings and 59 madds (the NAF), the kernel's own count.
It reads the affine base and 32 bytes of scalar a lane and writes a
Jacobian point. A call of a few lanes runs one thread's chain (mul_chain:
from the top non-zero NAF digit of any lane, a doubling a step below it and
a madd a step where some lane has a non-zero digit), which stands beside
the bound. The generator's (gen_cost; Mode B) needs, on a lane with k mod
r != 0, a madd for each table point after the first by the least of the
fixed-base methods the repo has tables for: the binary method on the
bases [2^j] G (popcount(k mod r) - 1 madds), its signed form (NAF weight
- 1) and genmul's 8-bit windows (a non-zero window after the first; 31 on
most scalars); it reads the table points its lanes use once and 32 bytes
a lane and writes a Jacobian point; its chain (gen_chain) is the pieces'
steps, then log2(64) adds, one lane's, which stands beside the bound. The
pairing's
kernels are counted in the cheapest published forms of its Fp2 operations
(MILLER_OPS, FEXP_OPS: a sparse line product, cyclotomic squares in the
hard part): about 3.4 M IMADs a lane for the Miller loop and 5.5 M for the
final exponentiation with its Fermat ladder; a lane reads 288 bytes and
writes 576 (K10), or reads and writes 576 (K11).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import random
import subprocess
import sys
import time

SEED = 20240521
LOG_N = 20
BATCHED_N = 8192  # below the fixed-base threshold: the batched-affine commit
REF_N = 10  # the reference CLI's polynomials (degree 9)
LADDER_CHECK_SIZES = (REF_N, 129, BATCHED_N)  # K2b's edge checks: the paths' n, a partial block
MUL_CHECK_SIZES = (1, REF_N - 1, 127, 128, 129, 1 << 16)  # the ladder kernels' edge checks
MUL_PLAIN_LANES = 256  # a wider ladder call's plain check: its first and last this many lanes
CHECK_LANES = 1 << 16  # lanes of the exceptional-case checks of phase 3
FOLD_CHECK_LANES = 4096  # the fold's: phase 5 checks it again at 2^16 lanes
PLAIN_CHUNK = 1 << 20  # lanes per plain call in the replays: bounds its temporaries
HBM_BYTES_PER_S = 3.35e12
INT_MAD_PER_S = 132 * 64 * 1.98e9
FP_MUL_OPS = 2 * (2 * 12 * 12 + 12)
FP_SQR_OPS = 2 * (12 * 13 // 2 + 12 * 12 + 12)
FR_MUL_OPS = 2 * (2 * 8 * 8 + 8)
G1_ADD_OPS = 11 * FP_MUL_OPS + 5 * FP_SQR_OPS
G1_MADD_OPS = 7 * FP_MUL_OPS + 4 * FP_SQR_OPS
G1_DBL_OPS = 2 * FP_MUL_OPS + 5 * FP_SQR_OPS
FP2_MUL_OPS = 2 * (3 * 12 * 12 + 2 * (12 * 12 + 12))  # Karatsuba, two reductions
FP2_SQR_OPS = 2 * FP_MUL_OPS  # the complex square: two Fp multiplies
G2_ADD_OPS = 11 * FP2_MUL_OPS + 5 * FP2_SQR_OPS
G2_MADD_OPS = 7 * FP2_MUL_OPS + 4 * FP2_SQR_OPS
G2_DBL_OPS = 2 * FP2_MUL_OPS + 5 * FP2_SQR_OPS
# the pairing's Fp2 operations (M a multiply, S a square, m an Fp product) in
# their cheapest published forms: a Miller doubling step with its line 3M +
# 6S + 4m, a mixed addition step 11M + 2S + 4m, an Fp12 square 12M (f is
# not yet cyclotomic), a sparse line product 13M; in the final
# exponentiation's hard part a cyclotomic square 9S (Granger-Scott), an
# Fp12 multiply 18M, a Frobenius 5M (two of them); its easy part an Fp12
# inversion (33M + 3S, 4 Fp products and one Fermat ladder), two multiplies
# and a Frobenius
MILLER_STEPS, MILLER_ADDS = 63, 5  # the bits of |x| below the top one; those set
E_HARD_SQRS, E_HARD_MULS = 125, 47  # (z - 1)^2 / 3: 126 bits, 48 set
Z_SQRS, Z_MULS = 63, 5
MILLER_OPS = (MILLER_STEPS * ((12 + 3 + 13) * FP2_MUL_OPS + 6 * FP2_SQR_OPS + 4 * FP_MUL_OPS)
              + MILLER_ADDS * ((11 + 13) * FP2_MUL_OPS + 2 * FP2_SQR_OPS + 4 * FP_MUL_OPS))
FEXP_SQRS = E_HARD_SQRS + 3 * Z_SQRS  # 314 cyclotomic squares
FEXP_MULS = E_HARD_MULS + 3 * Z_MULS + 1 + 3  # ^p, then the combination's three
FEXP_OPS = ((33 + 2 * 18 + 5 + 18 * FEXP_MULS + 2 * 5) * FP2_MUL_OPS
            + (3 + 9 * FEXP_SQRS) * FP2_SQR_OPS + 4 * FP_MUL_OPS)  # + ladder_ops(FP)
FP_BYTES = 48
FP2_BYTES = 96
FP12_BYTES = 576
MAX_FP_MULS_TABLES = 10  # Fp multiply launches the table build may make
MAX_FP_MULS_CEREMONY = 100  # and the whole ceremony
MAX_FR_MULS_PROOF = 4  # Fr multiply launches the proof may make
# a fixed-base commit's launches: the bucket reduction 1, K4 (the chunk
# offsets) 4, the point kernels the reduction replaced none
COMMIT_LAUNCHES = {"bucket_reduce": (1, 1), "hs_scan_points": (4, 4), "g1_add": (0, 0),
                   "g1_double": (0, 0)}
# a batched MSM's launches: K2b 1, the K2 kernels it replaced none
BATCHED_LAUNCHES = {"ladder_msm": 1, "g1_double": 0, "g1_madd": 0, "g1_add": 0}
# the bucket reduction's dependent point operations from input to output:
# V_b and V_top (thread 0 forms both), the leaf V_top - V_b, the block's
# tree of 8 levels and the last block's of 7
BUCKET_REDUCE_CHAIN = {"adds": 2 + 1 + 8 + 7, "doubles": 0}

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "mont_mul_fp": ("kzg_torch/csrc/mont_mul.cu", "kzg_tpu/ops/pallas_field.py:355"),
    "mont_mul_fr": ("kzg_torch/csrc/mont_mul.cu", "kzg_tpu/ops/pallas_field.py:355"),
    "inv_batch_fp": ("kzg_torch/csrc/inv_batch.cu", "kzg_tpu/ops/field.py:273"),
    "inv_batch_fr": ("kzg_torch/csrc/inv_batch.cu", "kzg_tpu/ops/field.py:273"),
    "g1_double": ("kzg_torch/csrc/g1_point.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    "g1_add": ("kzg_torch/csrc/g1_point.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    "g1_madd": ("kzg_torch/csrc/g1_point.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    "scan_madd": ("kzg_torch/csrc/scan_madd.cu", "kzg_tpu/ops/pallas_msm25.py:360"),
    "scan_buckets": ("kzg_torch/csrc/scan_madd.cu", "kzg_tpu/ops/pallas_msm25.py:387"),
    "hs_scan_points": ("kzg_torch/csrc/hs_scan.cu", "kzg_tpu/ops/pallas_msm.py:280"),
    "gen_fold": ("kzg_torch/csrc/gen_fold.cu", "kzg_tpu/ops/pallas_msm25.py:445"),
    "fold_entries": ("kzg_torch/csrc/gen_fold.cu", "kzg_tpu/ops/pallas_msm.py:396"),
    "dbl_chain": ("kzg_torch/csrc/dbl_chain.cu", "kzg_tpu/ops/pallas_msm.py:336"),
    "dbl_windows": ("kzg_torch/csrc/dbl_chain.cu", "kzg_tpu/ops/pallas_msm.py:336"),
    "fr_evaluate": ("kzg_torch/csrc/fr_poly.cu", "kzg_tpu/ops/poly.py:56"),
    "fr_divide": ("kzg_torch/csrc/fr_poly.cu", "kzg_tpu/ops/poly.py:69"),
    # K2 as the MSM's bucket reduction uses it (kzg_tpu/ops/msm.py:608-686, :817)
    "bucket_reduce": ("kzg_torch/csrc/bucket_reduce.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    # K2 as the batched MSM uses it (kzg_tpu/ops/msm.py:74-85, msm_batched_affine)
    "ladder_msm": ("kzg_torch/csrc/ladder_msm.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    # K9: G2's formulas, XLA around K1 in the JAX package (JacobianCurve over fp2)
    "g2_double": ("kzg_torch/csrc/g2_point.cu", "kzg_tpu/ops/curve.py:82"),
    "g2_add": ("kzg_torch/csrc/g2_point.cu", "kzg_tpu/ops/curve.py:103"),
    "g2_madd": ("kzg_torch/csrc/g2_point.cu", "kzg_tpu/ops/curve.py:137"),
    # K2 and K9 as the scalar multiplications use them (kzg_tpu/ops/curve.py:205-245,
    # mul_scalar and mul_scalar_affine): one launch a call, each group; Mode A the
    # signed-digit ladder on any base, Mode B the generator's scalar split into pieces
    "g1_ladder": ("kzg_torch/csrc/mul_ladder.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    "g2_ladder": ("kzg_torch/csrc/mul_ladder.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    "g1_gen_ladder": ("kzg_torch/csrc/mul_ladder.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    "g2_gen_ladder": ("kzg_torch/csrc/mul_ladder.cu", "kzg_tpu/ops/pallas_curve.py:260"),
    # K10 and K11: the pairing, XLA around K1 in the JAX package
    "miller_loop": ("kzg_torch/csrc/pairing.cu", "kzg_tpu/ops/pairing.py:117"),
    "final_exp": ("kzg_torch/csrc/pairing.cu", "kzg_tpu/ops/pairing.py:210"),
}
# kernel -> its CUDA functions in the -Xptxas -v report
DEVICE_FUNCTIONS = {
    "mont_mul_fp": ["mont_mul_kernel<12>"], "mont_mul_fr": ["mont_mul_kernel<8>"],
    "inv_batch_fp": ["inv_up_kernel<12>", "inv_top_kernel<12>", "inv_down_kernel<12>"],
    "inv_batch_fr": ["inv_up_kernel<8>", "inv_top_kernel<8>", "inv_down_kernel<8>"],
    "g1_double": ["g1_double_kernel"], "g1_add": ["g1_add_kernel"],
    "g1_madd": ["g1_madd_kernel"],
    "scan_madd": ["scan_madd_kernel<true>", "scan_madd_kernel<false>"],
    "scan_buckets": ["scan_buckets_kernel"],
    "hs_scan_points": ["hs_block_kernel", "hs_runs_kernel", "hs_offsets_kernel",
                       "hs_apply_kernel"],
    "gen_fold": ["gen_fold_kernel"], "fold_entries": ["fold_entries_kernel"],
    "dbl_chain": ["dbl_chain_kernel"], "dbl_windows": ["dbl_chain_kernel"],
    "fr_evaluate": ["fr_eval_kernel"],
    "fr_divide": ["fr_eval_kernel", "fr_div_top_kernel", "fr_div_down_kernel"],
    "bucket_reduce": ["bucket_reduce_kernel"],
    "ladder_msm": ["ladder_msm_kernel"],
    "g2_double": ["g2_double_kernel"], "g2_add": ["g2_add_kernel"], "g2_madd": ["g2_madd_kernel"],
    "g1_ladder": ["g1_ladder_kernel"], "g2_ladder": ["g2_ladder_kernel"],
    "g1_gen_ladder": ["g1_gen_ladder_kernel"], "g2_gen_ladder": ["g2_gen_ladder_kernel"],
    "miller_loop": ["miller_loop_kernel"], "final_exp": ["final_exp_kernel"],
}
SRS_CHUNK = 1 << 16  # the chunk bench.py passes to the JAX package's ceremony
DBL_STEPS = 16
CEREMONY = f"G1 ceremony 2^{LOG_N} (chunk 2^16)"
MAIN = f"fixed-base commit 2^{LOG_N} (table build + first commit)"
PROOF = f"opening proof 2^{LOG_N} (evaluate + generate_proof)"
BATCHED = f"batched-affine commit {BATCHED_N}"
REF = f"reference-size commit and proof {REF_N}"
SETUP_SECRET = bytes(range(32))  # tests/golden/setup.json's secret
LOG_SETUP = 16
SETUP_REF = f"generate_setup {REF_N} (the reference CLI's trusted-setup, no generator tables)"
SETUP = f"generate_setup 2^{LOG_SETUP}"
LOAD = f"load_setup 2^{LOG_SETUP} (both device batches, subgroup-checked)"
DECOMPRESS = f"g1_decompress_batch 2^{LOG_N} (the ceremony's points, subgroup-checked)"
SETUP_SPOT_LANES = 64  # lanes of the 2^16 setup's G2 held to hostmath
# the scalar multiplications' launches: one ladder a group a call, and none of
# the point formulas' kernels the ladders replaced
NO_FORMULAS = {"g1_double": 0, "g1_madd": 0, "g1_add": 0, "g2_double": 0, "g2_madd": 0,
               "g2_add": 0}
MODE_A, MODE_B = ("g1_ladder", "g2_ladder"), ("g1_gen_ladder", "g2_gen_ladder")
LADDERS = MODE_A + MODE_B
NO_LADDERS = dict.fromkeys(LADDERS, 0)
R_CHAIN = {"doubles": 255, "madds": 59}  # Mode A's [r] P: r's NAF has 60 non-zero digits
MAX_GEN_CHAIN = 40  # Mode B's point operations on one lane's chain, at most
# the reference-size setup (the generator multiplications of 9 lanes: Mode B)
# (every table holds every ladder's count, 0 where the path launches none)
SETUP_REF_LAUNCHES = {**NO_FORMULAS, **NO_LADDERS, "g1_gen_ladder": 1, "g2_gen_ladder": 1}
# the 2^16 setup's load (the subgroup check of each group's batch: Mode A)
LOAD_LAUNCHES = {**NO_FORMULAS, **NO_LADDERS, "g1_ladder": 1, "g2_ladder": 1}
# the 2^20 decompression: the G1 subgroup check
DECOMPRESS_LAUNCHES = {**NO_FORMULAS, **NO_LADDERS, "g1_ladder": 1}
G2_CHECK_SIZES = (1, 127, 128, 129)  # K9's edge checks; the paths' shapes are replayed
VERIFY = f"verify_proof 2^{LOG_N} (the main path's C, the proof path's pi, x and y)"
VERIFY_SIZES = (1, 16, 64)  # verify_proofs_batch's V; the largest is a driven path
VERIFY_BATCH = f"verify_proofs_batch {VERIFY_SIZES[-1]} (reference-size openings, item 7 wrong)"
PAIRING_CHECK_SIZES = (1, 2, 33, 128)  # K10's and K11's edge checks
# the pairing kernels' chains of dependent Fp12 operations a lane: the Miller
# loop's 63 squares, 63 + 5 line products and as many steps of T; the final
# exponentiation's inversion, 314 squares, 2 + 66 multiplies and 3 Frobenius
# maps (its conjugations are negations, not counted)
PAIRING_CHAINS = {
    "miller_loop": {"steps": MILLER_STEPS, "add_steps": MILLER_ADDS,
                    "fp12_ops": 2 * (MILLER_STEPS + MILLER_ADDS) + MILLER_STEPS},
    "final_exp": {"squares": FEXP_SQRS, "multiplies": 2 + FEXP_MULS,
                  "fp12_ops": 1 + FEXP_SQRS + 2 + FEXP_MULS + 3},
}
# a verify of V items without generator tables: K10 and K11 once, the
# generator ladders of x G2 and y G1 (Mode B), one add of each group
VERIFY_LAUNCHES = dict(SETUP_REF_LAUNCHES, miller_loop=1, final_exp=1, g1_add=1, g2_add=1)
# the kernels each path must launch
PATH_KERNELS = {
    CEREMONY: {"mont_mul_fp", "mont_mul_fr", "inv_batch_fp", "g1_madd", "gen_fold"},
    MAIN: {"mont_mul_fp", "mont_mul_fr", "inv_batch_fp", "dbl_windows", "scan_buckets",
           "hs_scan_points", "bucket_reduce"},
    PROOF: {"mont_mul_fr", "scan_buckets", "hs_scan_points", "bucket_reduce", "fr_evaluate",
            "fr_divide"},
    BATCHED: {"mont_mul_fr", "ladder_msm"},
    REF: {"ladder_msm", "fr_evaluate", "fr_divide"},
    SETUP_REF: {"mont_mul_fr", "mont_mul_fp", "inv_batch_fp", "g1_gen_ladder", "g2_gen_ladder"},
    SETUP: {"mont_mul_fr", "mont_mul_fp", "inv_batch_fp", "g1_madd", "gen_fold", "g2_madd"},
    LOAD: {"mont_mul_fp", "g1_ladder", "g2_ladder"},
    DECOMPRESS: {"mont_mul_fp", "g1_ladder"},
    VERIFY: {"mont_mul_fp", "inv_batch_fp", "g1_gen_ladder", "g2_gen_ladder", "g1_add", "g2_add",
             "miller_loop", "final_exp"},
    VERIFY_BATCH: {"mont_mul_fp", "inv_batch_fp", "g1_gen_ladder", "g2_gen_ladder", "g1_add",
                   "g2_add", "miller_loop", "final_exp"},
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def ladder_ops(F) -> int:
    """IMADs of one Fermat ladder x^(N - 2) in fixed 4-bit windows: a table
    of x^2 .. x^15 (14 multiplies), then 4 squares a window below the top one
    and a multiply for each non-zero window."""
    e = F.modulus - 2
    nibbles = [(e >> (4 * k)) & 15 for k in range((e.bit_length() + 3) // 4)]
    sqr = FP_SQR_OPS if F.L == 12 else FR_MUL_OPS
    mul = FP_MUL_OPS if F.L == 12 else FR_MUL_OPS
    return 4 * (len(nibbles) - 1) * sqr + (14 + sum(1 for d in nibbles[:-1] if d)) * mul


def inv_case(ctx, F, n: int):
    """(L, n) seeded values for the inversion with zero lanes: the first,
    the last and, when they exist, lanes 31, 32, 255, 256 (thread and block
    boundaries of the first pass' layout, whose runs stride 256 lanes) and
    8191, 8192 (block boundaries); lanes 1-3 hold 1, N - 1 and R mod N."""
    a = ctx.rand_field(F, n)
    a[:, 0] = 0
    a[:, n - 1] = 0
    if n >= 8:
        a[:, 1:4] = F.tensor([1, F.modulus - 1, F.R_int % F.modulus], ctx.device, mont=False)
    zeros = [i for i in (31, 32, 255, 256, 8191, 8192) if i < n]
    a[:, zeros] = 0
    return a


def check_inverse(ctx, F, a, inv) -> None:
    """Every non-zero lane of a times its inverse is Montgomery one, and
    every zero lane's inverse is zero."""
    from kzg_torch.ops import field as fld

    nz = ~F.is_zero(a)
    prod = fld.mont_mul_plain(a, inv, F)
    if not bool((prod[:, nz] == F.const("ONE", ctx.device)).all()) or bool(inv[:, ~nz].any()):
        raise AssertionError(f"inv_batch {F.name}: a lane times its inverse is not one")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_MAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Ctx:
    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(SEED)
        self.gc_ms = 0.0  # host time inside the garbage collector (gc_callback)
        self.path_gc_ms = {}
        self._gc_start = None
        self.ladder_chains = {}  # K2b's replayed call -> ladder_chain on its inputs

    def gc_callback(self, phase, info):
        """gc.callbacks hook: adds up the time of every collection."""
        if phase == "start":
            self._gc_start = time.perf_counter()
        elif self._gc_start is not None:
            self.gc_ms += (time.perf_counter() - self._gc_start) * 1e3
            self._gc_start = None

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def time_cuda(self, fn, reps: int = 5) -> float:
        """Mean ms of fn over reps runs, by CUDA events, after one warm-up."""
        torch = self.torch
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def time_once(self, fn) -> tuple[float, object]:
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return (time.perf_counter() - t0) * 1e3, out

    def rand_field(self, F, n: int):
        """n uniformly random canonical values as (L, n) int32 words: every
        word random, the top one kept below the modulus' top word."""
        torch = self.torch
        w = torch.randint(-(1 << 31), 1 << 31, (F.L, n), dtype=torch.int32,
                          device=self.device, generator=self.gen)
        w[-1] = torch.randint(0, F.modulus >> (32 * (F.L - 1)), (n,), dtype=torch.int32,
                              device=self.device, generator=self.gen)
        return w


def same(ctx, a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(same(ctx, x, y) for x, y in zip(a, b)) and len(a) == len(b)
    return bool(ctx.torch.equal(a, b))


def max_abs_err(ctx, a, b) -> int:
    """Largest |difference| of the u32 words (0 when bit-identical)."""
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(ctx, x, y) for x, y in zip(a, b))
    torch = ctx.torch
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max().item()) if ua.numel() else 0


def check(ctx, label, got, want) -> int:
    err = max_abs_err(ctx, got, want)
    ok = same(ctx, got, want)
    print(f"  {label}: {'bit-identical' if ok else 'MISMATCH'} (max word error {err})", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel differs from its plain version")
    return err


def special_points(ctx, n: int):
    """Jacobian p, q (12, n) with exceptional lanes first when n >= 20: lanes
    0-3 P == Q, 4-7 P == -Q, 8-11 P at infinity, 12-15 Q at infinity, 16-19
    both; the rest random canonical coordinates (the formulas take any
    canonical input; kernel and plain version must agree on all of them)."""
    from kzg_torch.ops.field import FP

    p = [ctx.rand_field(FP, n) for _ in range(3)]
    q = [ctx.rand_field(FP, n) for _ in range(3)]
    if n < 20:
        return tuple(p), tuple(q)
    one = FP.one_like(p[2][:, :20])
    p[2][:, :20] = one
    q[2][:, :20] = one
    for c in range(3):
        q[c][:, 0:4] = p[c][:, 0:4]
    q[0][:, 4:8] = p[0][:, 4:8]
    q[1][:, 4:8] = FP.neg(p[1][:, 4:8])
    p[2][:, 8:12] = 0
    q[2][:, 12:16] = 0
    p[2][:, 16:20] = 0
    q[2][:, 16:20] = 0
    return tuple(p), tuple(q)


def pairing_case(ctx, n: int):
    """Affine P (12, n) and Q (12, 2, n) for the pairing kernels: lane 0 the
    generators, the last lane (n > 1) the zero words of an infinity lane, the
    rest random canonical words (the Miller loop takes any; kernel and plain
    version must agree on all of them)."""
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops.field import FP

    gx, gy = cv.g1_gen_affine(ctx.device)
    hx, hy = cv.g2_gen_affine(ctx.device)
    p = [ctx.rand_field(FP, n) for _ in range(2)]
    q = [ctx.rand_field(FP, 2 * n).view(FP.L, 2, n) for _ in range(2)]
    for c, g in zip(p + q, (gx, gy, hx, hy)):
        c[..., :1] = g
        if n > 1:
            c[..., -1] = 0
    return tuple(p), tuple(q)


def hs_plain(ctx, pts, reverse: bool, exclusive: bool):
    """K4's plain version on (12, R, W) coordinates, exclusive by a shift."""
    torch = ctx.torch
    from kzg_torch.ops import scans

    out = scans.hs_scan_points_plain(*pts, reverse=reverse)
    if not exclusive:
        return out
    if reverse:
        return tuple(torch.cat([c[..., 1:], torch.zeros_like(c[..., :1])], -1) for c in out)
    return tuple(torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1) for c in out)


def fold_digits(ctx, n: int):
    """(32, n) int32 window digits with the fold's exceptional lanes first
    (kzg_torch/utils/fold_cases.py: a doubling lane, k = 0, k = r - 1, a
    zero digit in each window, a warp with three doubling lanes), the rest
    uniform from a seed the run's generator draws."""
    from kzg_torch.utils import fold_cases

    seed = int(ctx.torch.randint(0, 1 << 31, (1,), generator=ctx.gen, device=ctx.device))
    return fold_cases.fold_digits(n, seed, ctx.device)


def scan_case(ctx, rows: int, m: int, C: int):
    """Keys and sorted digits for the fused scan over a table of ``rows``
    rows, seeded: digit 0 first, a run of 2m + 3 equal digits (a whole chunk
    of one digit and runs across chunk boundaries), absent digits, negative
    digits throughout, and (for C >= 4) at the start of chunk 2 a pair equal
    to its predecessor (P == Q) and at chunk 3 its negation (P == -Q)."""
    torch = ctx.torch
    P = m * C
    row = torch.randint(0, rows, (P,), dtype=torch.int32, device=ctx.device, generator=ctx.gen)
    neg = torch.randint(0, 2, (P,), device=ctx.device, generator=ctx.gen).bool()
    if C >= 4:
        row[2 * m + 1], neg[2 * m + 1] = row[2 * m], neg[2 * m]
        row[3 * m + 1], neg[3 * m + 1] = row[3 * m], ~neg[3 * m]
    keys = torch.where(neg, row | -(1 << 31), row)
    rest = torch.randint(10, 1 << 15, (P - 2 * m - 8,), dtype=torch.int32, device=ctx.device,
                         generator=ctx.gen)
    digits = torch.cat([torch.zeros(5, dtype=torch.int32, device=ctx.device),
                        torch.full((2 * m + 3,), 9, dtype=torch.int32, device=ctx.device), rest])
    return keys, torch.sort(digits)[0]


def two_step_scan(ctx, table, keys, ds, m: int):
    """The path the fused scan replaced, on the card: gather the table
    points (y negated for a negative digit), the exact streaming scan (every
    prefix), then the chunk totals and the prefix at each digit's last
    position, in the fused scan's (totals, U) form."""
    torch = ctx.torch
    from kzg_torch.ops import scans
    from kzg_torch.ops.field import FP

    P = keys.numel()
    C = P // m
    rows = (keys & 0x7FFFFFFF).long()
    x = table[rows, : FP.L].t()
    y = FP.select(keys < 0, FP.neg(table[rows, FP.L :].t().contiguous()), table[rows, FP.L :].t())
    # (m, 12, C) streams with the kernel's strides: stream[j, :, c] = pair c m + j
    xs, ys = (torch.empty(m, FP.L, C, dtype=torch.int32, device=ctx.device).copy_(
        v.reshape(FP.L, C, m).permute(2, 0, 1)) for v in (x, y))
    runs, _ = scans.scan_prefix_madd(xs, ys, fast=False)
    last = torch.ones(P, dtype=torch.bool, device=ctx.device)
    last[:-1] = ds[1:] != ds[:-1]
    p = last.nonzero().squeeze(1)
    U = tuple(torch.zeros(FP.L, scans.N_BUCKET_SLOTS, dtype=torch.int32, device=ctx.device)
              for _ in range(3))
    for u, r in zip(U, runs):
        u[:, ds[p].long()] = r[p % m, :, p // m].t()
    return tuple(r[-1] for r in runs), U


def gathered_entries(ctx, tables, digits):
    """The (32, 12, n) x and y entry streams T[w][digits[w]]: K8's input."""
    tx, ty = tables
    w = ctx.torch.arange(digits.shape[0], device=digits.device)[:, None]
    idx = digits.long()
    return (tx[:, w, idx].permute(1, 0, 2).contiguous(),
            ty[:, w, idx].permute(1, 0, 2).contiguous())


def reduce_case(ctx, C: int):
    """Seeded inputs of the bucket reduction with C chunk offsets: random
    coordinate words (every seventh U slot and one offset at infinity),
    non-decreasing slots and chunks as bucket_indices makes them, the first
    3 buckets invalid."""
    torch = ctx.torch
    from kzg_torch.ops import scans
    from kzg_torch.ops.field import FP

    nb = scans.N_BUCKET_SLOTS
    U = tuple(ctx.rand_field(FP, nb) for _ in range(3))
    U[2][:, 1::7] = 0
    off = tuple(ctx.rand_field(FP, C) for _ in range(3))
    off[2][:, C // 2] = 0
    sort = lambda hi: torch.sort(torch.randint(0, hi, (nb,), dtype=torch.int32,  # noqa: E731
                                               device=ctx.device, generator=ctx.gen))[0]
    return U, off, sort(nb), sort(C), torch.arange(nb, device=ctx.device) >= 3


def reduce_cost(inputs):
    """(bytes, operations) of one bucket reduction: U, the offsets and the
    three index arrays read once, one point written; and the point
    operations the function needs, whatever route a kernel takes. S_b =
    V_b - V_(b-1) with V_(-1) infinity, so sum_b b S_b telescopes to
    2^15 V_top - sum_(b < 2^15) V_b: an add for each valid V_b, 2^15 - 1
    adds for the sum, 15 doublings of V_top and one subtraction."""
    U, off, _, _, valid = inputs
    nb, C = U[0].shape[1], off[0].shape[1]
    adds = int(valid.sum()) + (nb - 2) + 1
    return (3 * FP_BYTES * (nb + C) + 9 * nb + 3 * FP_BYTES,
            adds * G1_ADD_OPS + 15 * G1_DBL_OPS)


def _live_scalars(k, mask):
    """The scalars of the lanes not flagged in mask, as python ints."""
    from kzg_torch.ops import limbs as lb

    ks = lb.words_to_ints(k)
    return ks if mask is None else [v for v, m in zip(ks, mask.tolist()) if not m]


def bucket_ops(live: list, c: int) -> int:
    """IMADs of sum_i k_i P_i over the non-zero scalars live by the bucket
    method with c-bit windows, counted on these digits: in each window a
    mixed add for each non-zero digit but the first into its bucket, then
    the running sum from the highest digit d down (an add for each non-empty
    bucket below d, d - 1 adds for the total); then from the top window
    down, c doublings and an add a window."""
    import numpy as np

    if not live:
        return 0
    top = max(v.bit_length() for v in live)
    windows = -(-top // c)
    bits = np.unpackbits(np.frombuffer(b"".join(v.to_bytes(32, "little") for v in live),
                                       dtype=np.uint8).reshape(len(live), 32),
                         axis=1, bitorder="little").astype(np.int64)
    bits = np.pad(bits, ((0, 0), (0, max(windows * c - 256, 0))))[:, :windows * c]
    digits = (bits.reshape(len(live), windows, c) << np.arange(c)).sum(axis=2)
    madds = adds = 0
    for w in range(windows):
        used = np.flatnonzero(np.bincount(digits[:, w])[1:]) + 1
        if used.size:
            madds += int((digits[:, w] != 0).sum()) - used.size
            adds += used.size - 1 + int(used[-1]) - 1
    adds += windows - 1
    return madds * G1_MADD_OPS + adds * G1_ADD_OPS + c * (windows - 1) * G1_DBL_OPS


def ladder_cost(k, mask):
    """(bytes, operations) of one batched MSM on these scalars: (x, y) and
    the scalar words (and the mask) read once, one point written; and the
    point operations sum_i k_i P_i needs on the lanes not flagged and with
    k_i mod r != 0, whatever route a kernel takes: the fewer of the lanes'
    own ladders (bitlen - 1 doublings and popcount - 1 mixed adds a lane,
    its first set bit a copy of P_i, then one add fewer than such lanes)
    and the bucket method at its best window, c = 1 to 16 (bucket_ops)."""
    from kzg_torch.utils import hostmath as hm

    live = [v % hm.R for v in _live_scalars(k, mask)]
    live = [v for v in live if v]
    n = k.shape[1]
    ladder = (sum(v.bit_length() - 1 for v in live) * G1_DBL_OPS
              + sum(bin(v).count("1") - 1 for v in live) * G1_MADD_OPS
              + max(len(live) - 1, 0) * G1_ADD_OPS)
    ops = min([ladder] + [bucket_ops(live, c) for c in range(1, 17)])
    return n * (2 * FP_BYTES + 32 + (mask is not None)) + 3 * FP_BYTES, ops


def ladder_chain(k, mask=None) -> dict:
    """K2b's dependent point operations from input to output on these
    scalars: a double and a madd a step from the highest set bit of any lane
    down (the exceptional doublings aside), then the block's tree and the
    last block's levels."""
    from kzg_torch.ops import msm

    steps = max((v.bit_length() for v in _live_scalars(k, mask)), default=0)
    blocks = -(-k.shape[1] // msm.LADDER_LANES)
    return {"doubles": steps, "madds": steps,
            "adds": msm.LADDER_LANES.bit_length() - 1 + (blocks - 1).bit_length()}


def _ladder_ops(v: int, dbl: int, madd: int) -> int:
    """IMADs of [v] P, v > 0, on an affine P by the cheapest of three
    ladders: binary (bitlen(v) - 1 doublings, popcount - 1 madds), a fixed
    4-bit window (bitlen(v) - 1 doublings; a 14-point table of 2P .. 15P,
    then a madd a non-zero window below the top one) and the NAF (its top
    digit's index in doublings, weight - 1 madds)."""
    from kzg_torch.ops import curve as cv

    windows = [(v >> (4 * j)) & 15 for j in range((v.bit_length() + 3) // 4 - 1)]
    adds = min(bin(v).count("1") - 1, 14 + sum(1 for w in windows if w))
    plus, minus = cv.naf_int(v)
    naf = ((plus | minus).bit_length() - 1) * dbl + (bin(plus | minus).count("1") - 1) * madd
    return min((v.bit_length() - 1) * dbl + adds * madd, naf)


def mul_cost(scalars, n: int, masked: bool, g2: bool):
    """(bytes, operations) of one Mode A ladder call (g1_ladder, g2_ladder)
    of n lanes whose live lanes hold ``scalars`` (python ints): the affine
    base and the scalar words (and the mask) read once, the Jacobian output
    written; and the point operations [k] P needs on each lane with k != 0,
    whatever route a kernel takes: _ladder_ops, the cheapest of the binary,
    4-bit window and NAF ladders (not reduced: P may lie outside the
    subgroup)."""
    coord = FP2_BYTES if g2 else FP_BYTES
    dbl, madd = (G2_DBL_OPS, G2_MADD_OPS) if g2 else (G1_DBL_OPS, G1_MADD_OPS)
    ops = sum(count * _ladder_ops(v, dbl, madd)
              for v, count in collections.Counter(scalars).items() if v)
    return n * (2 * coord + 32 + masked) + 3 * coord * n, ops


def mul_chain(scalars) -> dict:
    """Mode A's dependent point operations on these live scalars, as one
    thread runs them: from the highest non-zero NAF digit of any lane (a
    copy of +-P), a doubling a step below it and a madd a step where some
    lane has a non-zero digit (the exceptional doublings aside)."""
    from kzg_torch.ops import curve as cv

    union = 0
    for v in set(scalars):
        plus, minus = cv.naf_int(v)
        union |= plus | minus
    return {"doubles": max(union.bit_length() - 1, 0),
            "madds": max(bin(union).count("1") - 1, 0)}


def _pieces(v: int) -> list:
    from kzg_torch.ops import curve as cv

    bits = cv.GEN_SPLIT_BITS
    return [(v >> (bits * j)) & ((1 << bits) - 1) for j in range(cv.GEN_SPLIT_PIECES)]


def gen_cost(scalars, n: int, g2: bool):
    """(bytes, operations) of one Mode B call (g1_gen_ladder,
    g2_gen_ladder) of n lanes holding ``scalars``: what [k] G needs on
    constant bases, whatever route a kernel takes. Each lane with k mod
    r != 0 needs, by the fixed-base methods the repo has tables for, a copy
    of its first table point and a madd for each further one: the binary
    method on the bases [2^j] G (curve.gen_pow2; popcount(k mod r) points),
    its signed form on the same bases (the NAF's weight; -Q is free on an
    affine Q) or genmul's 8-bit windows (a point of the 32 x 256-point
    tables for each non-zero window of k mod r). A method reads the table
    points its lanes use, each once, and 32 bytes of scalar a lane, and
    writes a Jacobian point a lane; of the three, the one of least bound_ms
    is returned."""
    from kzg_torch.ops import curve as cv
    from kzg_torch.utils import hostmath as hm

    coord = FP2_BYTES if g2 else FP_BYTES
    madd = G2_MADD_OPS if g2 else G1_MADD_OPS

    def binary(v):
        return {j for j in range(v.bit_length()) if v >> j & 1}

    def signed(v):
        plus, minus = cv.naf_int(v)
        return binary(plus | minus)

    def windows(v):
        return {(w, v >> (8 * w) & 255) for w in range(32) if v >> (8 * w) & 255}

    costs = []
    for points in (binary, signed, windows):
        used, ops = set(), 0
        for v, count in collections.Counter(k % hm.R for k in scalars).items():
            if v:
                pts = points(v)
                used |= pts
                ops += count * (len(pts) - 1) * madd
        costs.append((len(used) * 2 * coord + n * (32 + 3 * coord), ops))
    return min(costs, key=lambda c: bound_ms(*c)[0])


def gen_chain(scalars) -> dict:
    """Mode B's dependent point operations on these scalars, as a lane's
    threads run them: from the highest bit of any piece (a copy of the
    base), a doubling a step below it and a madd a step where some piece
    has the bit, then the log2(GEN_SPLIT_PIECES) levels of the pieces'
    tree."""
    from kzg_torch.ops import curve as cv

    union = 0
    for v in set(scalars):
        for d in _pieces(v):
            union |= d
    return {"doubles": max(union.bit_length() - 1, 0),
            "madds": max(bin(union).count("1") - 1, 0),
            "adds": cv.GEN_SPLIT_PIECES.bit_length() - 1}


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version, exceptional cases
# ---------------------------------------------------------------------------


def phase_kernels(ctx):
    torch = ctx.torch
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import field as fld
    from kzg_torch.ops import scans
    from kzg_torch.ops.field import FP, FR

    n = CHECK_LANES
    for F in (FP, FR):
        # first: every pair of N - 1, 0, 1 and R mod N (words as given), the
        # carry chains' extremes
        a, b = ctx.rand_field(F, n), ctx.rand_field(F, n)
        edge = [F.modulus - 1, 0, 1, F.R_int % F.modulus]
        a[:, :16] = F.tensor([x for x in edge for _ in edge], ctx.device, mont=False)
        b[:, :16] = F.tensor([y for _ in edge for y in edge], ctx.device, mont=False)
        check(ctx, f"mont_mul {F.name} (L={F.L}, n={n}, N-1 / 0 / 1 / R mod N pairs)",
              fld.mont_mul(a, b, F), fld.mont_mul_plain(a, b, F))

    p, q = special_points(ctx, n)
    qa = (q[0], q[1])
    check(ctx, f"g1_double (n={n}, inf lanes)", cv.g1_double(p), cv.g1_double_plain(p))
    check(ctx, f"g1_add (n={n}, P == Q / P == -Q / inf lanes)", cv.g1_add(p, q),
          cv.g1_add_plain(p, q))
    check(ctx, f"g1_madd (n={n}, P == Q / P == -Q / inf lanes)", cv.g1_madd(p, qa),
          cv.g1_madd_plain(p, qa))
    got, need = cv.g1_madd(p, qa, fast=True)
    want, want_need = cv.g1_madd_plain(p, qa, fast=True)
    check(ctx, f"g1_madd fast (n={n})", (got, need), (want, want_need))
    if not bool(need[:4].all()) or bool(need[4:].any()):
        raise AssertionError("madd fast: the needs-double mask is not set exactly on P == Q lanes")

    # K3 on an adversarial stream: odd C < 64, a P == Q step in chunks 0 and 5
    m_small, c_small = 8, 37
    xs = ctx.rand_field(FP, m_small * c_small).view(FP.L, m_small, c_small).permute(1, 0, 2)
    ys = ctx.rand_field(FP, m_small * c_small).view(FP.L, m_small, c_small).permute(1, 0, 2)
    for c in (0, 5):
        xs[1, :, c] = xs[0, :, c]
        ys[1, :, c] = ys[0, :, c]
    for fast in (True, False):
        got, flag = scans.scan_prefix_madd(xs, ys, fast=fast)
        want, want_flag = scans.scan_prefix_madd_plain(xs, ys, fast=fast)
        check(ctx, f"scan_madd {'fast' if fast else 'exact'} (m={m_small}, C={c_small}, P == Q)",
              got, want)
        if fast and not (bool(flag) and bool(want_flag)):
            raise AssertionError("scan fast: the needs-double flag was not raised")

    # the fused K3 on the same kinds of stream, against its plain version
    # and against the streaming path it replaced
    from kzg_torch.ops import msm

    tab_rows = 64
    table = msm.point_table((ctx.rand_field(FP, tab_rows), ctx.rand_field(FP, tab_rows)))
    for m_small, c_small in ((8, 37), (16, 5), (1, 40)):
        keys, ds = scan_case(ctx, tab_rows, m_small, c_small)
        got = scans.scan_buckets(table, keys, ds, m_small)
        check(ctx, f"scan_buckets (m={m_small}, C={c_small}, digit 0 / absent / runs across "
              f"chunks / one-digit chunk / P == Q / P == -Q)", got,
              scans.scan_buckets_plain(table, keys, ds, m_small))
        check(ctx, f"scan_buckets against the streaming path (m={m_small}, C={c_small})", got,
              two_step_scan(ctx, table, keys, ds, m_small))

    # K5 / K8 on a fold with every exceptional lane, K7 at 1, 5 and 16 steps
    from kzg_torch.ops import genmul
    from kzg_torch.utils import fold_cases

    tables = genmul._build_tables(ctx.device)  # not cached: the ceremony path builds its own
    digits = fold_digits(ctx, FOLD_CHECK_LANES)
    got = genmul.gen_fold(*tables, digits)
    check(ctx, f"gen_fold (n={FOLD_CHECK_LANES}, zero digits / k = 0 / r - 1 / doubling lanes)",
          got, genmul.gen_fold_plain(*tables, digits.long()))
    lanes = [0, 1, 2, 3, 35]  # a doubling lane, k = 0, r - 1, a zero digit, a doubling warp
    if cv.g1_from_device(tuple(c[:, lanes] for c in got)) != fold_cases.oracle(digits, lanes):
        raise AssertionError("gen_fold: the exceptional lanes differ from the host oracle")
    xs, ys = gathered_entries(ctx, tables, digits)
    check(ctx, f"fold_entries (W=32, C={FOLD_CHECK_LANES})", genmul.fold_entries(xs, ys), got)
    check(ctx, f"fold_entries plain (W=32, C={FOLD_CHECK_LANES})",
          genmul.fold_entries_plain(xs, ys), got)
    for W in (128, CHECK_LANES):
        p = special_points(ctx, W)[0]
        for steps in (1, 5, DBL_STEPS):
            check(ctx, f"dbl_chain (W={W}, steps={steps}, inf lanes)", cv.dbl_chain(p, steps),
                  cv.dbl_chain_plain(p, steps))
        for steps, windows in ((1, 3), (DBL_STEPS, 2)):
            check(ctx, f"dbl_windows (W={W}, steps={steps}, windows={windows})",
                  cv.dbl_windows(p[:2], steps, windows), cv.dbl_windows_plain(p[:2], steps, windows))

    # the batched inversion: n = 1, 2, a partial run in a partial block
    # (the first pass' blocks hold 256 * INV_RUN lanes), two blocks and one
    # lane, all zero
    for F in (FP, FR):
        for n_inv in (1, 2, 300, fld.INV_BLOCK * fld.INV_RUN + 300 + 7,
                      2 * fld.INV_BLOCK * fld.INV_RUN + 1):
            a = inv_case(ctx, F, n_inv)
            got = F.inv_batch(a)
            check(ctx, f"inv_batch {F.name} (n={n_inv}, zeros at run and block boundaries, "
                  f"1 / p - 1 / R mod p)", got, F.inv_batch_plain(a))
            check_inverse(ctx, F, a, got)
        z = torch.zeros(F.L, 5000, dtype=torch.int32, device=ctx.device)
        check(ctx, f"inv_batch {F.name} (n=5000, all zero)", F.inv_batch(z), z)

    # K4: all four modes at one block (3 x 32), one segment with a partial
    # run (257), a partial run in a partial segment over 2 rows, and the
    # commit's 131,072
    for R, W in ((3, 32), (1, 257), (2, 2641), (1, 131072)):
        pts = [ctx.rand_field(FP, R * W).view(FP.L, R, W) for _ in range(3)]
        pts[2][:, :, 1::7] = 0  # infinity lanes
        for reverse in (False, True):
            for exclusive in (False, True):
                check(ctx, f"hs_scan_points R={R} W={W} reverse={reverse} exclusive={exclusive}",
                      scans.hs_scan_points(*pts, reverse=reverse, exclusive=exclusive),
                      hs_plain(ctx, pts, reverse, exclusive))


def phase_poly_kernels(ctx):
    """K1e and K1d against both plain versions (the pair-up recursion and
    the kernels' decomposition) at n = 1, 2, a run's length minus and plus
    one, a tile, a tile and one and two, and 128 tiles and five (the top
    pass takes two tiles a thread), each at x = 0, 1, r - 1 and a seeded
    point; then the division through Polynomial.divide_by_root: a
    polynomial with a known root gives its other factor, a non-root raises
    ProtocolError."""
    from kzg_torch import Polynomial, ProtocolError, Scalar
    from kzg_torch.ops import poly as polyops
    from kzg_torch.ops.field import FR
    from kzg_torch.utils import hostmath as hm

    rnd = random.Random(SEED + 1)
    tile = polyops.POLY_BLOCK * polyops.POLY_RUN
    points = [FR.tensor([x], ctx.device)[:, 0] for x in (0, 1, hm.R - 1, rnd.randrange(hm.R))]
    for n in (1, 2, polyops.POLY_RUN - 1, polyops.POLY_RUN + 1, tile, tile + 1, tile + 2,
              polyops.POLY_BLOCK * tile + 5):
        c = ctx.rand_field(FR, n)
        got = tuple(polyops.evaluate(c, x) for x in points)
        check(ctx, f"fr_evaluate (n={n}, x = 0 / 1 / r - 1 / seeded)", got,
              tuple(polyops.evaluate_plain(c, x) for x in points))
        check(ctx, f"fr_evaluate against the runs (n={n})", got,
              tuple(polyops.evaluate_runs_plain(c, x) for x in points))
        if n < 2:
            continue
        got = tuple(polyops.synthetic_divide(c, x) for x in points)
        check(ctx, f"fr_divide (n={n}, root = 0 / 1 / r - 1 / seeded)", got,
              tuple(polyops.synthetic_divide_plain(c, x) for x in points))
        check(ctx, f"fr_divide against the runs (n={n})", got,
              tuple(polyops.synthetic_divide_runs_plain(c, x) for x in points))
    # P = (X - root) Q: the division gives Q; at another point it raises
    root = rnd.randrange(hm.R)
    q = [rnd.randrange(hm.R) for _ in range(tile + 3)]
    p = [(a - root * b) % hm.R for a, b in zip([0] + q, q + [0])]
    poly = Polynomial.from_ints(p, device=ctx.device)
    if poly.divide_by_root(Scalar(root)).coefficient_ints() != q:
        raise AssertionError("divide_by_root at a root differs from the other factor")
    try:
        poly.divide_by_root(Scalar(root + 1))
    except ProtocolError:
        print(f"  divide_by_root (n={len(p)}): the other factor at the root, ProtocolError at "
              f"a non-root", flush=True)
    else:
        raise AssertionError("divide_by_root at a non-root did not raise ProtocolError")


def phase_reduce_edges(ctx, C: int):
    """The bucket reduction on its exceptional inputs (the case table of
    kzg_torch/utils/reduce_cases.py), each against bucket_reduce_plain and
    that route replayed on K2's add (bit-identical) and the host oracle
    (sum_b b k_b) G1: every bucket invalid; only S_top (every leaf equal:
    the add doubles at every level); only b = 0 (weight 0: infinity); only
    b = 2^15 - 1; equal leaves; P and -P meeting at a block-tree level and
    in the last block's tree (infinity). Then seeded words at the commit's
    C, against both."""
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import msm
    from kzg_torch.utils import reduce_cases

    def both(label, inputs):
        got = msm.bucket_reduce(*inputs)
        check(ctx, f"bucket_reduce, {label}", got, msm.bucket_reduce_plain(*inputs))
        check(ctx, f"bucket_reduce, {label}, the same route on K2's add", got,
              msm.bucket_reduce_plain(*inputs, add=cv.g1_add))
        return got

    for label, buckets in reduce_cases.BUCKET_CASES.items():
        got = both(label, reduce_cases.bucket_case(buckets, ctx.device, valid=bool(buckets)))
        if cv.g1_from_device(tuple(g[:, None] for g in got)) != reduce_cases.weighted_oracle(
                buckets):
            raise AssertionError(f"bucket_reduce, {label}: differs from the host oracle")
    both(f"seeded words, C={C}", reduce_case(ctx, C))


# ---------------------------------------------------------------------------
# Phase 4: the paths, with every wrapper call logged
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def logging_calls():
    """Inside the block, count each outermost call of a kernel wrapper by its
    spec (kernel, shape, mode): what the replay needs to rebuild inputs of the
    same shapes. The wrappers are swapped in their modules and put back."""
    from kzg_torch.ops import curve as cv, field as fld, genmul, msm, scans
    from kzg_torch.ops import pairing as pr
    from kzg_torch.ops import poly as polyops

    calls = collections.Counter()
    depth = [0]
    hs = lambda x, y, z, reverse=False, exclusive=False: (  # noqa: E731
        "hs_scan_points", tuple(x.shape), reverse, exclusive)
    specs = [
        (fld, "mont_mul", lambda a, b, F: (f"mont_mul_{F.name.lower()}", tuple(a.shape))),
        (fld, "inv_batch", lambda a, F: (f"inv_batch_{F.name.lower()}", tuple(a.shape))),
        (cv, "g1_double", lambda p: ("g1_double", tuple(p[0].shape))),
        (cv, "g1_add", lambda p, q: ("g1_add", tuple(p[0].shape))),
        (cv, "g1_madd", lambda p, q, fast=False: ("g1_madd", tuple(p[0].shape), fast)),
        (scans, "scan_prefix_madd", lambda xs, ys, fast=True: ("scan_madd", tuple(xs.shape), fast)),
        (scans, "scan_buckets", lambda table, keys, ds, m, nb=scans.N_BUCKET_SLOTS: (
            "scan_buckets", tuple(table.shape), tuple(keys.shape), m, nb)),
        (scans, "hs_scan_points", hs),
        (genmul, "gen_fold", lambda tx, ty, digits: ("gen_fold", tuple(digits.shape))),
        (genmul, "fold_entries", lambda xs, ys: ("fold_entries", tuple(xs.shape))),
        (cv, "dbl_chain", lambda p, steps: ("dbl_chain", tuple(p[0].shape), steps)),
        (cv, "dbl_windows", lambda p, steps, windows: (
            "dbl_windows", tuple(p[0].shape), steps, windows)),
        (polyops, "evaluate", lambda coeffs, x: ("fr_evaluate", tuple(coeffs.shape))),
        (polyops, "synthetic_divide", lambda coeffs, root: ("fr_divide", tuple(coeffs.shape))),
        (msm, "bucket_reduce", lambda U, off, slot, c, valid: (
            "bucket_reduce", tuple(U[0].shape), tuple(off[0].shape))),
        (msm, "msm_batched_affine", lambda pts, scalars, inf_mask=None: (
            "ladder_msm", tuple(scalars.shape), inf_mask is not None)),
        (cv, "g2_double", lambda p: ("g2_double", tuple(p[0].shape))),
        (cv, "g2_add", lambda p, q: ("g2_add", tuple(p[0].shape))),
        (cv, "g2_madd", lambda p, q: ("g2_madd", tuple(p[0].shape))),
        (cv, "g1_ladder", lambda p, k, inf=None: (
            "g1_ladder", tuple(p[0].shape), k if isinstance(k, int) else None, inf is not None)),
        (cv, "g2_ladder", lambda p, k, inf=None: (
            "g2_ladder", tuple(p[0].shape), k if isinstance(k, int) else None, inf is not None)),
        (cv, "g1_gen_ladder", lambda k: ("g1_gen_ladder", tuple(k.shape))),
        (cv, "g2_gen_ladder", lambda k: ("g2_gen_ladder", tuple(k.shape))),
        (pr, "miller_loop", lambda p, q: ("miller_loop", tuple(p[0].shape))),
        (pr, "final_exponentiation", lambda f: ("final_exp", tuple(f.shape))),
    ]
    originals = []

    def logged(fn, spec):
        def wrapper(*args, **kwargs):
            if depth[0] == 0:
                calls[spec(*args, **kwargs)] += 1
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return wrapper

    for mod, attr, spec in specs:
        fn = getattr(mod, attr)
        originals.append((mod, attr, fn))
        setattr(mod, attr, logged(fn, spec))
    try:
        yield calls
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


def drive(ctx, label, fn):
    """Run fn as one path: counts set to 0 before, read after, calls logged."""
    from kzg_torch.ops import _build

    _build.reset_launches()
    gc_before = ctx.gc_ms
    with logging_calls() as calls:
        ms, out = ctx.time_once(fn)
    launches = dict(_build.LAUNCHES)
    ctx.path_gc_ms[label] = ctx.gc_ms - gc_before
    print(f"  {label}: {ms:.1f} ms, of which {ctx.path_gc_ms[label]:.1f} ms in the garbage "
          f"collector; launches {launches}", flush=True)
    missing = sorted(k for k in PATH_KERNELS[label] if launches.get(k, 0) == 0)
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    return ms, out, launches, dict(calls)


def check_commit_launches(label, launches):
    """A path with one fixed-base commit launched the bucket reduction
    once, K4 4 times and K2's add and double never."""
    for name, (lo, hi) in COMMIT_LAUNCHES.items():
        got = launches.get(name, 0)
        if not lo <= got <= hi:
            raise AssertionError(f"{label}: {got} {name} launches on its one commit "
                                 f"(expected {lo} to {hi})")


def check_launches(label, launches, table):
    """The path launched each kernel of ``table`` as often as it says."""
    for name, count in table.items():
        if launches.get(name, 0) != count:
            raise AssertionError(f"{label}: {launches.get(name, 0)} {name} launches "
                                 f"(expected {count})")


def check_batched_launches(label, launches, msms: int):
    """A path with ``msms`` batched MSMs launched K2b once for each and K2's
    double, madd and add never."""
    check_launches(label, launches, {k: v * msms for k, v in BATCHED_LAUNCHES.items()})


def phase_paths(ctx):
    torch = ctx.torch
    from kzg_torch import Polynomial, Scalar
    from kzg_torch.ops import _build
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import genmul
    from kzg_torch.ops.field import FR
    from kzg_torch.trusted_setup import DeviceSRS
    from kzg_torch.utils import hostmath as hm

    n = 1 << LOG_N
    rnd = random.Random(SEED)
    secret = rnd.randrange(1, hm.R)
    powers, pw = [], 1
    for _ in range(n):
        powers.append(pw)
        pw = pw * secret % hm.R
    coeffs = [rnd.randrange(hm.R) for _ in range(n)]
    x_eval = rnd.randrange(hm.R)

    def oracle(k):
        return hm.g1_mul(hm.G1_GEN, sum(c * p for c, p in zip(coeffs[:k], powers[:k])) % hm.R)

    # set-up, not counted: the SRS points s^i G1 by the double-and-add ladder,
    # the ceremony's independent reference on the card
    k = FR.tensor(powers, ctx.device, mont=False)
    t_srs, srs_jac = ctx.time_once(
        lambda: cv.mul_scalar_affine(cv.g1_gen_affine(ctx.device, n), k))
    t_aff, ((lx, ly), inf) = ctx.time_once(lambda: cv.to_affine(srs_jac))
    del srs_jac, k
    if bool(inf.any()):
        raise AssertionError("the ladder's SRS holds the point at infinity")
    print(f"  set-up, ladder SRS 2^{LOG_N} points: ladder {t_srs:.1f} ms, to_affine "
          f"{t_aff:.1f} ms", flush=True)
    # the set-up's objects (among them the oracles' 2^20-element lists) live
    # to the end: freeze them out of the garbage collector, as
    # tests/conftest.py freezes its heap, so that no path pays a collection
    # over them; each path's own collector time is still reported
    gc.collect()
    gc.freeze()

    # ceremony path: the generator tables and the window fold, chunk by chunk
    if genmul.tables_built(ctx.device):
        raise AssertionError("the generator tables exist before the ceremony path")
    def ceremony():
        return genmul.chunked_srs_g1(secret, n, chunk=SRS_CHUNK, device=ctx.device)

    t_cer, (gx, gy), cer_launches, cer_calls = drive(ctx, CEREMONY, ceremony)
    if not (torch.equal(gx, lx) and torch.equal(gy, ly)):
        bad = int(((gx != lx).any(0) | (gy != ly).any(0)).sum())
        raise AssertionError(f"the ceremony's SRS differs from the ladder's on {bad} lanes")
    del lx, ly
    spot = [0, 1, 2, n // 3, n - 1]
    got_spot = cv.g1_from_device((gx[:, spot], gy[:, spot], cv.FP.one_like(gx[:, spot])))
    if got_spot != [hm.g1_mul(hm.G1_GEN, powers[i]) for i in spot]:
        raise AssertionError("SRS points differ from s^i G1")
    cer_warm = sorted(ctx.time_once(ceremony)[0] for _ in range(3))
    print(f"  ceremony 2^{LOG_N}: {t_cer:.1f} ms first (table build included), median of 3 "
          f"warm runs {cer_warm[1]:.1f} ms ({cer_warm}); equals the ladder on all {n} lanes "
          f"and s^i G1 on lanes {spot}", flush=True)

    # main path: table build and first commit at 2^20 against the ceremony's SRS
    srs = DeviceSRS(gx, gy, None, [], n)
    poly = Polynomial.from_ints(coeffs, device=ctx.device)
    p_at_s = sum(c * p for c, p in zip(coeffs, powers)) % hm.R
    expected = hm.g1_mul(hm.G1_GEN, p_at_s)
    torch.cuda.reset_peak_memory_stats()

    def main_path():
        t_tab, _ = ctx.time_once(srs.fixed_tables)
        tab_launches.update(_build.LAUNCHES)
        return t_tab, poly.commit(srs)

    tab_launches = collections.Counter()
    t_path, (t_tab, c), launches, calls = drive(ctx, MAIN, main_path)
    for label, got, cap in (("the table build", tab_launches, MAX_FP_MULS_TABLES),
                            ("the ceremony", cer_launches, MAX_FP_MULS_CEREMONY)):
        if got.get("mont_mul_fp", 0) > cap:
            raise AssertionError(f"{label} made {got['mont_mul_fp']} Fp multiply launches "
                                 f"(at most {cap})")
    print(f"  the table build's launches {dict(tab_launches)}", flush=True)
    wide_doubles = [spec for spec in calls if spec[0] == "g1_double" and spec[1][-1] >= n]
    if launches.get("dbl_windows") != 1 or wide_doubles:
        raise AssertionError(f"the table build made {launches.get('dbl_windows', 0)} windowed "
                             f"chain launches and 2^{LOG_N}-lane doublings {wide_doubles}")
    if launches.get("scan_madd"):
        raise AssertionError("the commit launched the streaming scan")
    check_commit_launches(MAIN, launches)
    if c.affine() != expected:
        raise AssertionError("commit differs from the host oracle (sum a_i s^i mod r) G1")
    print(f"  table build {t_tab:.1f} ms, first commit {t_path - t_tab:.1f} ms; equals the host "
          f"oracle (sum a_i s^i mod r) G1", flush=True)
    peak_path = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        dt, c2 = ctx.time_once(lambda: poly.commit(srs))
        times.append(dt)
        if c2.affine() != expected:
            raise AssertionError("a warm commit differs from the oracle")
    times.sort()
    med = times[1]
    peak_commit = torch.cuda.max_memory_allocated() / 2**30
    print(f"  commit 2^{LOG_N}: median of 3 warm runs {med:.1f} ms ({times}), "
          f"{n / med * 1e3:.0f} points/s; peak memory {peak_path:.2f} GiB over the table build "
          f"and first commit, {peak_commit:.2f} GiB over the warm commits", flush=True)

    # proof path: evaluate at x, then pi = commit((P - y) / (X - x))
    x = Scalar(x_eval)

    def proof_path():
        ev = poly.evaluate(x)
        return ev, ev.generate_proof(poly, srs)

    t_proof, (ev, proof), proof_launches, proof_calls = drive(ctx, PROOF, proof_path)
    if proof_launches.get("scan_madd"):
        raise AssertionError("the proof launched the streaming scan")
    check_commit_launches(PROOF, proof_launches)
    if proof_launches.get("mont_mul_fr", 0) > MAX_FR_MULS_PROOF:
        raise AssertionError(f"the proof made {proof_launches['mont_mul_fr']} Fr multiply "
                             f"launches (at most {MAX_FR_MULS_PROOF})")
    y = 0
    for co in reversed(coeffs):
        y = (y * x_eval + co) % hm.R
    if ev.result.to_int() != y:
        raise AssertionError("P(x) differs from the host's Horner value")
    want = (p_at_s - y) * pow(secret - x_eval, -1, hm.R) % hm.R
    if proof.affine() != hm.g1_mul(hm.G1_GEN, want):
        raise AssertionError("the proof differs from the host oracle ((P(s) - y) / (s - x)) G1")
    proof_times = []
    for _ in range(3):
        dt, (ev2, proof2) = ctx.time_once(proof_path)
        proof_times.append(dt)
        if ev2.result.to_int() != y or proof2 != proof:
            raise AssertionError("a warm proof differs from the first")
    proof_times.sort()
    print(f"  proof 2^{LOG_N}: {t_proof:.1f} ms first, median of 3 warm runs "
          f"{proof_times[1]:.1f} ms ({proof_times}); y equals the host's P(x) and the proof "
          f"((P(s) - y) / (s - x) mod r) G1", flush=True)
    stages = phase_stages(ctx, secret, poly, x, srs)

    # last path: the batched-affine commit below the fixed-base threshold
    ns = BATCHED_N
    small_srs = DeviceSRS(gx[:, :ns].contiguous(), gy[:, :ns].contiguous(), None, [], ns)
    small = Polynomial.from_ints(coeffs[:ns], device=ctx.device)
    t_small, cs, small_launches, small_calls = drive(ctx, BATCHED,
                                                     lambda: small.commit(small_srs))
    check_batched_launches(BATCHED, small_launches, 1)
    if cs.affine() != oracle(ns):
        raise AssertionError(f"the {ns}-point commit differs from the host oracle")
    small_times = sorted(ctx.time_once(lambda: small.commit(small_srs))[0] for _ in range(3))
    print(f"  commit {ns}: equals the host oracle; median of 3 warm runs "
          f"{small_times[1]:.2f} ms ({small_times})", flush=True)

    # the reference CLI's size: a 10-coefficient commit and its proof
    # against the 2^20 SRS (the commit takes its first 10 points)
    ref = Polynomial.from_ints(coeffs[:REF_N], device=ctx.device)

    def ref_proof():
        ev = ref.evaluate(x)
        return ev, ev.generate_proof(ref, srs)

    def ref_path():
        return ref.commit(srs), ref_proof()

    t_ref, (c_ref, (ev_ref, pf_ref)), ref_launches, ref_calls = drive(ctx, REF, ref_path)
    check_batched_launches(REF, ref_launches, 2)
    p_ref = sum(c * p for c, p in zip(coeffs[:REF_N], powers)) % hm.R
    y_ref = 0
    for co in reversed(coeffs[:REF_N]):
        y_ref = (y_ref * x_eval + co) % hm.R
    if c_ref.affine() != hm.g1_mul(hm.G1_GEN, p_ref):
        raise AssertionError(f"the {REF_N}-coefficient commit differs from the host oracle")
    if ev_ref.result.to_int() != y_ref:
        raise AssertionError(f"the {REF_N}-coefficient P(x) differs from the host's Horner value")
    want = (p_ref - y_ref) * pow(secret - x_eval, -1, hm.R) % hm.R
    if pf_ref.affine() != hm.g1_mul(hm.G1_GEN, want):
        raise AssertionError(f"the {REF_N}-coefficient proof differs from the host oracle")
    ref_commit = sorted(ctx.time_once(lambda: ref.commit(srs))[0] for _ in range(3))
    ref_proofs = sorted(ctx.time_once(ref_proof)[0] for _ in range(3))
    print(f"  {REF}: {t_ref:.2f} ms first (commit and proof); commit median of 3 warm runs "
          f"{ref_commit[1]:.2f} ms ({ref_commit}), proof {ref_proofs[1]:.2f} ms "
          f"({ref_proofs}); commit, P(x) and proof equal the host oracles", flush=True)

    paths = {CEREMONY: (cer_launches, cer_calls), MAIN: (launches, calls),
             PROOF: (proof_launches, proof_calls), BATCHED: (small_launches, small_calls),
             REF: (ref_launches, ref_calls)}
    setup_paths, setup_times = phase_setup(ctx, gx, gy)
    paths.update(setup_paths)
    verify_paths, verify_times = phase_verify(ctx, srs, secret, (c, proof, ev),
                                              (ref, c_ref, pf_ref, ev_ref))
    paths.update(verify_paths)
    return paths, {"setup": setup_times, "verify": verify_times, "ladder_srs_ms": t_srs,
                   "ladder_to_affine_ms": t_aff,
                   "ceremony_first_ms": t_cer, "ceremony_ms": cer_warm[1],
                   "ceremony_runs_ms": cer_warm, "tables_ms": t_tab,
                   "tables_launches": dict(tab_launches),
                   "first_commit_ms": t_path - t_tab, "commit_ms": med, "commit_runs_ms": times,
                   "peak_gib_tables_and_first_commit": peak_path, "peak_gib_warm_commits": peak_commit,
                   "first_proof_ms": t_proof, "proof_ms": proof_times[1],
                   "proof_runs_ms": proof_times, "stages": stages,
                   "batched_first_commit_ms": t_small, "batched_commit_ms": small_times[1],
                   "batched_commit_runs_ms": small_times, "ref_first_ms": t_ref,
                   "ref_commit_ms": ref_commit[1], "ref_commit_runs_ms": ref_commit,
                   "ref_proof_ms": ref_proofs[1], "ref_proof_runs_ms": ref_proofs,
                   }, lambda: poly.commit(srs)


def host_setup_bytes(secret: int, n: int) -> str:
    """setup.json of n points rendered by hostmath alone: the bytes the
    ceremony must give."""
    from kzg_torch import artifacts as art
    from kzg_torch.utils import hostmath as hm

    items, pw = [], 1
    for _ in range(n):
        items.append({"g1": list(hm.g1_compress(hm.g1_mul(hm.G1_GEN, pw))),
                      "g2": list(hm.g2_compress(hm.g2_mul(hm.G2_GEN, pw)))})
        pw = pw * secret % hm.R
    return art.dumps(items)


def compress_g1(ctx, x, y):
    """Affine Montgomery words (12, n) -> n 48-byte ZCash encodings,
    vectorized: x big-endian with the compression flag, the sign flag
    where y > (p - 1) / 2 (no point here is infinity)."""
    import numpy as np
    from kzg_torch.ops import codec
    from kzg_torch.ops.field import FP

    xs = np.ascontiguousarray(FP.from_mont(x).cpu().numpy().view("<u4").T)
    raw = np.ascontiguousarray(xs.view(np.uint8)[:, ::-1])
    sign = codec._gt_half(FP.from_mont(y)).cpu().numpy()
    raw[:, 0] |= np.uint8(0x80) | (sign.astype(np.uint8) << 5)
    return [row.tobytes() for row in raw]


def phase_setup(ctx, gx, gy):
    """The setup paths, each driven with the counts set to 0:
    (a) the reference CLI's trusted-setup, generate_setup of 10 points from
    tests/golden/setup.json's secret, in a process without generator
    tables (each group's generator ladder, Mode B, one launch), against
    hostmath's rendering and that file, SetupArtifactsGenerator's first 10
    items too; (b) generate_setup of 2^16 points from a seeded secret:
    G1 against chunked_srs_g1 on every lane, G2's K9 route against the
    plain route on the card (tables and fold, fp2 on FP.mul) on every lane
    and against hostmath on 64; (c) save_setup, then load_setup through
    both device batches with the subgroup checks: the same bytes back,
    kzg_tpu's rejections of three tampered files, DeviceSRS.load's words
    those of DeviceSRS.from_artifacts; (d) the 2^20 ceremony's points
    compressed, then g1_decompress_batch with the subgroup check: the
    ceremony's words back."""
    import json

    torch = ctx.torch
    from kzg_torch import DeviceSRS, Scalar, SetupArtifactsGenerator, generate_setup
    from kzg_torch import artifacts as art
    from kzg_torch.errors import SerializationError
    from kzg_torch.ops import codec, fp2, genmul
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import poly as polyops
    from kzg_torch.ops.field import FP, FR
    from kzg_torch.utils import hostmath as hm

    t_phase = time.perf_counter()
    out, paths = {}, {}

    def run(label, fn):
        ms, res, launches, calls = drive(ctx, label, fn)
        paths[label] = (launches, calls)
        return ms, res

    # (a): a fresh process has no tables; the ceremony path built G1's
    genmul._tables.clear()
    secret = Scalar.from_be_bytes(SETUP_SECRET)
    want = host_setup_bytes(secret.to_int(), REF_N)
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                          "setup.json")
    with open(golden) as f:
        if f.read() != want:
            raise AssertionError("hostmath's 10-point setup.json differs from the golden file")

    def ref_setup():
        return generate_setup(secret, REF_N, device=ctx.device)

    t_ref, ref = run(SETUP_REF, ref_setup)
    check_launches(SETUP_REF, paths[SETUP_REF][0], SETUP_REF_LAUNCHES)
    t_gen, items = ctx.time_once(lambda: SetupArtifactsGenerator(SETUP_SECRET, device=ctx.device)
                                 .take(REF_N))
    for label, got in (("generate_setup", ref), ("SetupArtifactsGenerator", items)):
        if art.dumps([a.to_json() for a in got]) != want:
            raise AssertionError(f"{label}'s 10-point setup.json differs from the golden bytes")
    ref_runs = sorted(ctx.time_once(ref_setup)[0] for _ in range(3))
    if genmul.tables_built(ctx.device, cv.G1) or genmul.tables_built(ctx.device, cv.G2):
        raise AssertionError("the reference-size setup built generator tables")
    out.update(ref_first_ms=t_ref, ref_ms=ref_runs[1], ref_runs_ms=ref_runs,
               generator_take10_ms=t_gen)
    print(f"  {SETUP_REF}: {t_ref:.1f} ms first, median of 3 warm runs {ref_runs[1]:.1f} ms "
          f"({ref_runs}); SetupArtifactsGenerator.take(10) {t_gen:.1f} ms; both equal "
          f"tests/golden/setup.json", flush=True)

    # (b)
    n = 1 << LOG_SETUP
    s = random.Random(SEED + 3).randrange(1, hm.R)

    def big_setup():
        return generate_setup(Scalar(s), n, device=ctx.device)

    t_big, setup = run(SETUP, big_setup)
    big_runs = sorted(ctx.time_once(big_setup)[0] for _ in range(2))
    g1_ints = [a.g1.affine() for a in setup]
    sx, sy = genmul.chunked_srs_g1(s, n, chunk=n, device=ctx.device)
    if not (torch.equal(FP.tensor([p[0] for p in g1_ints], ctx.device), sx)
            and torch.equal(FP.tensor([p[1] for p in g1_ints], ctx.device), sy)):
        raise AssertionError(f"{SETUP}: G1 differs from chunked_srs_g1's words")
    std = FR.from_mont(polyops.power_sequence(FR.tensor([s], ctx.device)[:, 0], n))[:, 1:]
    k9 = genmul.mul_gen(std, group=cv.G2)
    plain_tables = genmul._build_tables(ctx.device, cv.G2, madd=cv.g2_madd_plain)
    if not same(ctx, plain_tables, genmul.gen_tables(ctx.device, cv.G2)):
        raise AssertionError(f"{SETUP}: the G2 tables differ from the plain route's")
    digits = genmul._digits8(std)
    check(ctx, f"{SETUP}: G2 by K9 against the plain route on the card, {n - 1} lanes", k9,
          genmul.fold_g2(*plain_tables, digits, madd=cv.g2_madd_plain))
    (x2, y2), _ = cv.g2_to_affine(k9)
    g2_ints = [a.g2.affine() for a in setup]
    if not (torch.equal(fp2.tensor([p[0] for p in g2_ints[1:]], ctx.device), x2)
            and torch.equal(fp2.tensor([p[1] for p in g2_ints[1:]], ctx.device), y2)):
        raise AssertionError(f"{SETUP}: G2 differs from the K9 route's words")
    lanes = sorted({0, 1, n - 1} | set(random.Random(SEED + 4).sample(range(n), SETUP_SPOT_LANES - 3)))
    if any(g2_ints[k] != hm.g2_mul(hm.G2_GEN, pow(s, k, hm.R)) for k in lanes):
        raise AssertionError(f"{SETUP}: G2 differs from hostmath's s^k G2")
    out.update(big_first_ms=t_big, big_ms=big_runs)
    print(f"  {SETUP}: {t_big:.1f} ms first (tables built), warm {big_runs}; G1 equals "
          f"chunked_srs_g1 and G2 the plain route on all {n} lanes, G2 hostmath on "
          f"{len(lanes)} lanes", flush=True)

    # (c)
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "setup.json")
    out["save_ms"], _ = ctx.time_once(lambda: art.save_setup(setup, path))
    with open(path) as f:
        text = f.read()
    t_load, loaded = run(LOAD, lambda: art.load_setup(path, device=ctx.device))
    check_launches(LOAD, paths[LOAD][0], LOAD_LAUNCHES)
    if art.dumps([a.to_json() for a in loaded]) != text:
        raise AssertionError(f"{LOAD}: the loaded setup re-serializes to other bytes")
    raw = json.loads(text)
    off_curve = [0x80] + [0] * 46 + [1]
    while hm.fp_sqrt(off_curve[-1] ** 3 + hm.B_G1) is not None:
        off_curve[-1] += 1
    k = 1
    while hm.fp2_sqrt(hm.fp2_add(hm.fp2_mul(hm.fp2_sq((k, 0)), (k, 0)), hm.B_G2)) is None:
        k += 1
    off_subgroup = ((k, 0), hm.fp2_sqrt(hm.fp2_add(hm.fp2_mul(hm.fp2_sq((k, 0)), (k, 0)),
                                                   hm.B_G2)))
    x_big = list(bytes([0x80 | (hm.P >> 376)]) + hm.P.to_bytes(48, "big")[1:])
    bad_path = os.path.join(folder, "tampered.json")
    for lane, key, value, message in (
            (n // 2, "g2", list(hm.g2_compress(off_subgroup)),
             "Point not in the prime-order subgroup"),
            (n - 1, "g1", off_curve, "Point not on curve"),
            (7, "g1", x_big, "x coordinate not in field")):
        entry = raw[lane]
        raw[lane] = dict(entry, **{key: value})
        with open(bad_path, "w") as f:
            f.write(art.dumps(raw))
        raw[lane] = entry
        try:
            art.load_setup(bad_path, device=ctx.device)
        except SerializationError as e:
            if str(e) != message:
                raise AssertionError(f"{LOAD}: {key} at {lane} raised {e!r}, not {message!r}")
        else:
            raise AssertionError(f"{LOAD}: a tampered {key} at {lane} loaded")
    t_srs, srs = ctx.time_once(lambda: DeviceSRS.load(path, device=ctx.device))
    want_srs = DeviceSRS.from_artifacts(setup, device=ctx.device)
    if not (torch.equal(srs.g1_x, want_srs.g1_x) and torch.equal(srs.g1_y, want_srs.g1_y)
            and srs.g1_inf is None and srs.g2 == want_srs.g2):
        raise AssertionError(f"{LOAD}: DeviceSRS.load differs from DeviceSRS.from_artifacts")
    out["device_srs_load_ms"] = t_srs
    print(f"  {LOAD}: save {out['save_ms']:.1f} ms, load {t_load:.1f} ms, the same bytes back; "
          f"an off-subgroup G2, an off-curve G1 and x >= p rejected with kzg_tpu's messages; "
          f"DeviceSRS.load {t_srs:.1f} ms, equal to from_artifacts", flush=True)

    # (d)
    t_cmp, blobs = ctx.time_once(lambda: compress_g1(ctx, gx, gy))
    spot = [0, 1, gx.shape[1] - 1]
    if [blobs[i] for i in spot] != [hm.g1_compress(p) for p in cv.g1_from_device(
            (gx[:, spot], gy[:, spot], FP.one_like(gx[:, spot])))]:
        raise AssertionError("the vectorized compression differs from hostmath's")
    t_dec, jac = run(DECOMPRESS, lambda: codec.g1_decompress_batch(blobs, True, ctx.device))
    check_launches(DECOMPRESS, paths[DECOMPRESS][0], DECOMPRESS_LAUNCHES)
    if not same(ctx, jac, (gx, gy, FP.one_like(gx))):
        raise AssertionError(f"{DECOMPRESS}: differs from the ceremony's words")
    out.update(load_ms=t_load, decompress_ms=t_dec, compress_ms=t_cmp,
               phase_s=time.perf_counter() - t_phase)
    print(f"  {DECOMPRESS}: {t_dec:.1f} ms (compressing {t_cmp:.1f} ms, set-up); equals the "
          f"ceremony's words on all {gx.shape[1]} lanes", flush=True)
    print(f"  the setup phase (a)-(d), checks included: {out['phase_s']:.1f} s", flush=True)
    return paths, out


def phase_verify(ctx, srs, secret, opening, ref_opening):
    """The verify paths, after the setup paths, each driven with the counts
    set to 0, in a state without generator tables (as a verifier's process
    is; the ceremony's and the setup's tables are set aside and put back):
    (a) Evaluation.verify_proof of the main path's C and the proof path's
    pi, x and y against the 2^20 SRS, whose s G2 comes from hostmath (set-
    up): True in the first run and 3 warm runs, and False for a wrong y,
    pi + G1 and C + G1; K10 and K11 once, the ladders' and the adds'
    launches as VERIFY_LAUNCHES; (b) the reference-size proof against a
    list of 10 SetupArtifact (hostmath's s^k G1, s^k G2); (c)
    verify_proofs_batch at V = 1, 16 and 64 on openings of the
    reference-size polynomial at seeded points (made by the port, set-up),
    item 7 given a wrong y: the expected list, first and warm (V = 64 the
    driven path); (d) bilinear_map equal to hostmath.pairing on two seeded
    pairs (aG1, bG2), e(aG1, bG2) = e(abG1, G2), and one where either side
    is infinity."""
    from kzg_torch import G1Point, G2Point, Scalar, bilinear_map
    from kzg_torch.ops import genmul
    from kzg_torch.polynomial import Evaluation, verify_proofs_batch
    from kzg_torch.trusted_setup import SetupArtifact
    from kzg_torch.utils import hostmath as hm

    t_phase = time.perf_counter()
    out, paths = {}, {}
    c, proof, ev = opening
    ref, c_ref, pf_ref, ev_ref = ref_opening
    srs.g2 = [G2Point.from_affine(hm.G2_GEN), G2Point.from_affine(hm.g2_mul(hm.G2_GEN, secret))]
    tables = dict(genmul._tables)
    genmul._tables.clear()
    try:
        # (a)
        def verify():
            return ev.verify_proof(proof, c, srs)

        t_first, ok, launches, calls = drive(ctx, VERIFY, verify)
        paths[VERIFY] = (launches, calls)
        if ok is not True:
            raise AssertionError(f"{VERIFY}: the proof does not verify")
        check_launches(VERIFY, launches, VERIFY_LAUNCHES)
        runs = []
        for _ in range(3):
            ms, ok = ctx.time_once(verify)
            runs.append(ms)
            if ok is not True:
                raise AssertionError(f"{VERIFY}: a warm run does not verify")
        runs.sort()
        wrong_y = Evaluation(ev.point, Scalar((ev.result.to_int() + 1) % hm.R))
        pi_g = G1Point.from_affine(hm.g1_add(proof.affine(), hm.G1_GEN))
        c_g = G1Point.from_affine(hm.g1_add(c.affine(), hm.G1_GEN))
        for label, (e, pf, cm) in (("a wrong y", (wrong_y, proof, c)), ("pi + G1", (ev, pi_g, c)),
                                   ("C + G1", (ev, proof, c_g))):
            if e.verify_proof(pf, cm, srs) is not False:
                raise AssertionError(f"{VERIFY}: {label} verifies")
        out.update(first_ms=t_first, ms=runs[1], runs_ms=runs)
        print(f"  {VERIFY}: {t_first:.1f} ms first, median of 3 warm runs {runs[1]:.1f} ms "
              f"({runs}); True, and False for a wrong y, pi + G1 and C + G1", flush=True)

        # (b)
        pw = [pow(secret, k, hm.R) for k in range(REF_N)]
        arts = [SetupArtifact(G1Point.from_affine(hm.g1_mul(hm.G1_GEN, k)),
                              G2Point.from_affine(hm.g2_mul(hm.G2_GEN, k))) for k in pw]
        out["ref_list_ms"], ok = ctx.time_once(
            lambda: ev_ref.verify_proof(pf_ref, c_ref, arts, device=ctx.device))
        if ok is not True:
            raise AssertionError(f"the {REF_N}-coefficient proof does not verify against a "
                                 f"list of SetupArtifact")
        print(f"  verify_proof {REF_N} against a list of {REF_N} SetupArtifact: "
              f"{out['ref_list_ms']:.1f} ms, True", flush=True)

        # (c)
        rnd = random.Random(SEED + 5)
        openings = []
        for _ in range(VERIFY_SIZES[-1]):
            e = ref.evaluate(Scalar(rnd.randrange(hm.R)))
            openings.append((e.generate_proof(ref, srs), e))
        out["batch"] = {}
        for v in VERIFY_SIZES:
            pfs = [o[0] for o in openings[:v]]
            evs = [o[1] for o in openings[:v]]
            if v > 7:
                evs[7] = Evaluation(evs[7].point, Scalar((evs[7].result.to_int() + 1) % hm.R))
            want = [i != 7 for i in range(v)]

            def batch():
                return verify_proofs_batch(pfs, [c_ref] * v, evs, srs)

            if v == VERIFY_SIZES[-1]:
                t_b, got, launches, calls = drive(ctx, VERIFY_BATCH, batch)
                paths[VERIFY_BATCH] = (launches, calls)
                check_launches(VERIFY_BATCH, launches, VERIFY_LAUNCHES)
            else:
                t_b, got = ctx.time_once(batch)
            warm = []
            for _ in range(3):
                ms, again = ctx.time_once(batch)
                warm.append(ms)
                got = got if again == got else None
            warm.sort()
            if got != want:
                raise AssertionError(f"verify_proofs_batch {v}: {got}, expected {want}")
            out["batch"][v] = {"first_ms": t_b, "ms": warm[1], "runs_ms": warm}
            print(f"  verify_proofs_batch {v}: {t_b:.1f} ms first, median of 3 warm runs "
                  f"{warm[1]:.1f} ms ({warm}); the expected list", flush=True)

        # (d)
        rnd = random.Random(SEED + 6)
        G1, G2 = G1Point.from_affine, G2Point.from_affine
        for _ in range(2):
            a, b = rnd.randrange(1, hm.R), rnd.randrange(1, hm.R)
            pa, qb = hm.g1_mul(hm.G1_GEN, a), hm.g2_mul(hm.G2_GEN, b)
            t_e, e = ctx.time_once(lambda: bilinear_map(G1(pa), G2(qb), ctx.device))
            if e != hm.pairing(pa, qb):
                raise AssertionError("bilinear_map differs from hostmath.pairing")
        if e != bilinear_map(G1(hm.g1_mul(hm.G1_GEN, a * b)), G2(hm.G2_GEN), ctx.device):
            raise AssertionError("bilinear_map: e(aG1, bG2) != e(abG1, G2)")
        for p1, p2 in ((G1(None), G2(qb)), (G1(pa), G2(None))):
            if bilinear_map(p1, p2, ctx.device) != hm.FP12_ONE:
                raise AssertionError("bilinear_map with infinity on one side is not one")
        out["bilinear_map_ms"] = t_e
        print(f"  bilinear_map: equals hostmath.pairing on two seeded pairs ({t_e:.1f} ms), "
              f"e(aG1, bG2) = e(abG1, G2), one where either side is infinity", flush=True)
    finally:
        genmul._tables.clear()
        genmul._tables.update(tables)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  the verify phase (a)-(d), checks included: {out['phase_s']:.1f} s", flush=True)
    return paths, out


def phase_stages(ctx, secret, poly, x, srs):
    """Host-clock times of the ceremony's and the proof's stages, each run
    alone after its path (warm): the ceremony's per chunk of 2^16 and
    scaled to 2^20 by the chunk count, the proof's at 2^20."""
    from kzg_torch import Polynomial
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import genmul
    from kzg_torch.ops import poly as polyops
    from kzg_torch.ops.field import FR

    chunks = (1 << LOG_N) // SRS_CHUNK
    s_mont = FR.tensor([secret], ctx.device)[:, 0]
    out = {}
    out["ceremony_tables_ms"], _ = ctx.time_once(lambda: genmul._build_tables(ctx.device))
    t, ladder = ctx.time_once(lambda: polyops.power_sequence(s_mont, SRS_CHUNK))
    out["ceremony_powers_ms"] = t
    k = FR.from_mont(ladder)
    t, jac = ctx.time_once(lambda: genmul.mul_gen(k))
    out["ceremony_fold_ms_per_chunk"], out["ceremony_fold_ms"] = t, t * chunks
    t, _ = ctx.time_once(lambda: cv.to_affine(jac))
    out["ceremony_to_affine_ms_per_chunk"], out["ceremony_to_affine_ms"] = t, t * chunks
    t, ev = ctx.time_once(lambda: poly.evaluate(x))
    out["proof_evaluate_ms"] = t
    t, diff = ctx.time_once(lambda: poly.sub(Polynomial.from_constant(ev.result, ctx.device)))
    out["proof_sub_ms"] = t
    t, q = ctx.time_once(lambda: diff.divide_by_root(x))
    out["proof_divide_ms"] = t
    out["proof_quotient_msm_ms"], _ = ctx.time_once(lambda: q.commit(srs))
    print("  stages: " + ", ".join(f"{key} {v:.2f}" for key, v in out.items()), flush=True)
    return out


def phase_profile(ctx, commit):
    """One warm commit under torch.profiler: device time by kernel, and the
    device's busy share of the wall time (kernels on one stream do not
    overlap, so their sum is the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = ctx.time_once(commit)
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): an aten op's row repeats
        # the time of the kernels it launched
        if evt.device_type != DeviceType.CUDA:
            continue
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  profiled commit: {wall_ms:.2f} ms wall, {busy:.2f} ms device busy "
          f"({busy / wall_ms:.1%}; idle {1 - busy / wall_ms:.1%}), {len(rows)} device kernels",
          flush=True)
    for ms, count, key in rows[:20]:
        print(f"    {ms:9.3f} ms  x{count:<5} {key[:100]}", flush=True)
    # the table-point gathers the fused scan replaced wrote (12, 16 n) words
    # each: one alone takes at least this long at the card's memory rate
    gather_ms = sum(ms for ms, _, key in rows if "index_elementwise" in key)
    one_table_gather_ms = 12 * 4 * 16 * (1 << LOG_N) / HBM_BYTES_PER_S * 1e3
    print(f"  index gathers {gather_ms:.4f} ms, against {one_table_gather_ms:.4f} ms for one "
          f"table gather", flush=True)
    if gather_ms >= one_table_gather_ms:
        raise AssertionError("the commit still gathers table points")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "index_gather_ms": gather_ms,
            "top": [[k[:60], c, ms] for ms, c, k in rows[:12]]}


# ---------------------------------------------------------------------------
# Phase 5: every logged call replayed at its shapes, checked and timed
# ---------------------------------------------------------------------------


def chunked(torch, fn, args, n: int):
    """fn over lane slices [i, i + PLAIN_CHUNK) of (L, n) word tensors (nested
    in tuples), the outputs concatenated along the last axis."""
    def cut(a, i, j):
        return tuple(cut(x, i, j) for x in a) if isinstance(a, tuple) else a[..., i:j]

    def cat(parts):
        if isinstance(parts[0], tuple):
            return tuple(cat([p[k] for p in parts]) for k in range(len(parts[0])))
        return torch.cat(parts, dim=-1)

    return cat([fn(*cut(args, i, min(i + PLAIN_CHUNK, n)))
                for i in range(0, max(n, 1), PLAIN_CHUNK)])


def replay_case(ctx, spec):
    """Seeded inputs at a logged call's shapes. Returns (kernel call, plain
    call, bytes, operations): both calls give the same flat layout."""
    torch = ctx.torch
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import field as fld
    from kzg_torch.ops import scans
    from kzg_torch.ops.field import FP, FR

    name, shape = spec[0], spec[1]
    if name.startswith("mont_mul"):
        F, ops = (FP, FP_MUL_OPS) if name == "mont_mul_fp" else (FR, FR_MUL_OPS)
        n = math.prod(shape[1:])
        a, b = ctx.rand_field(F, n), ctx.rand_field(F, n)
        return (lambda: fld.mont_mul(a.view(shape), b.view(shape), F).reshape(F.L, n),
                lambda: chunked(torch, lambda x, y: fld.mont_mul_plain(x, y, F), (a, b), n),
                3 * 4 * F.L * n, ops * n)
    if name.startswith("inv_batch"):
        F = FP if name == "inv_batch_fp" else FR
        n = math.prod(shape[1:])
        a = inv_case(ctx, F, n)
        mul = FP_MUL_OPS if F is FP else FR_MUL_OPS
        return (lambda: F.inv_batch(a.view(shape)).reshape(F.L, n),
                lambda: chunked(torch, F.inv_batch_plain, (a,), n),
                2 * 4 * F.L * n, 3 * (n - 1) * mul + ladder_ops(F))
    if name in ("g1_double", "g1_add", "g1_madd"):
        n = math.prod(shape[1:])
        p, q = special_points(ctx, n)
        qa = (q[0], q[1])
        view = lambda pt: tuple(c.view(shape) for c in pt)  # noqa: E731
        flat = lambda pt: tuple(c.reshape(FP.L, n) for c in pt)  # noqa: E731
        if name == "g1_double":
            return (lambda: flat(cv.g1_double(view(p))),
                    lambda: chunked(torch, cv.g1_double_plain, (p,), n),
                    6 * FP_BYTES * n, G1_DBL_OPS * n)
        if name == "g1_add":
            return (lambda: flat(cv.g1_add(view(p), view(q))),
                    lambda: chunked(torch, cv.g1_add_plain, (p, q), n),
                    9 * FP_BYTES * n, G1_ADD_OPS * n)
        fast = spec[2]

        def madd():
            out = cv.g1_madd(view(p), view(qa), fast=fast)
            return (flat(out[0]), out[1].reshape(n)) if fast else flat(out)

        return (madd,
                lambda: chunked(torch, lambda x, y: cv.g1_madd_plain(x, y, fast), (p, qa), n),
                (8 * FP_BYTES + (4 if fast else 0)) * n, G1_MADD_OPS * n)
    if name == "scan_madd":
        m, _, C = shape
        fast = spec[2]
        xs = ctx.rand_field(FP, m * C).view(FP.L, m, C).permute(1, 0, 2)
        ys = ctx.rand_field(FP, m * C).view(FP.L, m, C).permute(1, 0, 2)
        return (lambda: scans.scan_prefix_madd(xs, ys, fast=fast),
                lambda: scans.scan_prefix_madd_plain(xs, ys, fast),
                5 * FP_BYTES * m * C, G1_MADD_OPS * m * C)
    if name == "scan_buckets":
        (rows, _), (P,), m, nb = shape, spec[2], spec[3], spec[4]
        C = P // m
        from kzg_torch.ops import msm

        table = msm.point_table((ctx.rand_field(FP, rows), ctx.rand_field(FP, rows)))
        # a sort's permutation of the rows, random signs, sorted uniform digits
        perm = torch.randperm(rows, device=ctx.device, generator=ctx.gen)[:P].to(torch.int32)
        neg = torch.randint(0, 2, (P,), device=ctx.device, generator=ctx.gen).bool()
        keys = torch.where(neg, perm | -(1 << 31), perm)
        ds = torch.sort(torch.randint(0, nb, (P,), dtype=torch.int32, device=ctx.device,
                                      generator=ctx.gen))[0]
        return (lambda: scans.scan_buckets(table, keys, ds, m),
                lambda: scans.scan_buckets_plain(table, keys, ds, m, nb),
                2 * FP_BYTES * P + 8 * P + 3 * FP_BYTES * (C + nb), G1_MADD_OPS * (P - C))
    if name == "dbl_windows":
        steps, windows = spec[2], spec[3]
        n = shape[1]
        p = special_points(ctx, n)[0][:2]
        def plain(*q):  # (12, windows, lanes): chunks join along the lanes
            return tuple(c.view(FP.L, windows, -1) for c in cv.dbl_windows_plain(q, steps, windows))

        return (lambda: cv.dbl_windows(p, steps, windows),
                lambda: tuple(c.reshape(FP.L, windows * n) for c in chunked(torch, plain, p, n)),
                2 * FP_BYTES * n + 3 * FP_BYTES * windows * n,
                steps * (windows - 1) * G1_DBL_OPS * n)
    if name == "hs_scan_points":
        reverse, exclusive = spec[2], spec[3]
        W = shape[-1]
        R = math.prod(shape[1:-1])
        pts = [ctx.rand_field(FP, R * W) for _ in range(3)]
        pts[2][:, 1::7] = 0  # infinity lanes
        adds = R * max(W - (2 if exclusive else 1), 0)
        return (lambda: tuple(c.reshape(FP.L, R * W) for c in scans.hs_scan_points(
                    *(c.view(shape) for c in pts), reverse=reverse, exclusive=exclusive)),
                lambda: tuple(c.reshape(FP.L, R * W) for c in hs_plain(
                    ctx, tuple(c.view(FP.L, R, W) for c in pts), reverse, exclusive)),
                6 * FP_BYTES * R * W, adds * G1_ADD_OPS)
    if name in ("gen_fold", "fold_entries"):
        from kzg_torch.ops import genmul

        W, n = (shape[0], shape[1]) if name == "gen_fold" else (shape[0], shape[2])
        tables = genmul.gen_tables(ctx.device)
        digits = fold_digits(ctx, n)
        # the madds these digits need: one per non-zero digit after a lane's first
        nz = (digits != 0).sum(0)
        n_ops = int((nz - (nz > 0).to(nz.dtype)).sum()) * G1_MADD_OPS
        if name == "gen_fold":
            return (lambda: genmul.gen_fold(*tables, digits),
                    lambda: chunked(torch, lambda d: genmul.gen_fold_plain(*tables, d.long()),
                                    (digits,), n),
                    4 * W * n + 2 * FP_BYTES * W * 256 + 3 * FP_BYTES * n, n_ops)
        xs, ys = gathered_entries(ctx, tables, digits)
        return (lambda: genmul.fold_entries(xs, ys),
                lambda: genmul.fold_entries_plain(xs, ys),
                2 * FP_BYTES * W * n + 3 * FP_BYTES * n, n_ops)
    if name in ("fr_evaluate", "fr_divide"):
        from kzg_torch.ops import poly as polyops

        n = shape[1]
        c, x = ctx.rand_field(FR, n), ctx.rand_field(FR, 1)[:, 0]
        if name == "fr_evaluate":
            return (lambda: polyops.evaluate(c, x), lambda: polyops.evaluate_plain(c, x),
                    4 * FR.L * n, FR_MUL_OPS * (n - 1))
        return (lambda: polyops.synthetic_divide(c, x),
                lambda: polyops.synthetic_divide_plain(c, x),
                4 * FR.L * (2 * n - 1), FR_MUL_OPS * (n - 2))
    if name == "bucket_reduce":
        from kzg_torch.ops import msm

        inputs = reduce_case(ctx, spec[2][1])
        return (lambda: msm.bucket_reduce(*inputs), lambda: msm.bucket_reduce_plain(*inputs),
                *reduce_cost(inputs))
    if name == "ladder_msm":
        from kzg_torch.ops import msm

        n = shape[1]
        x, y, k = ctx.rand_field(FP, n), ctx.rand_field(FP, n), ctx.rand_field(FR, n)
        mask = torch.arange(n, device=ctx.device) % 61 == 5 if spec[2] else None
        ctx.ladder_chains[spec] = ladder_chain(k, mask)
        return (lambda: msm.msm_batched_affine((x, y), k, mask),
                lambda: msm.msm_batched_plain((x, y), k, mask), *ladder_cost(k, mask))
    if name in ("g2_double", "g2_add", "g2_madd"):
        from kzg_torch.utils import g2_cases

        n = math.prod(shape[2:])
        p, q, qa = g2_cases.case_points(n, SEED, ctx.device)
        view = lambda pt: tuple(c.view(shape) for c in pt)  # noqa: E731
        flat = lambda pt: tuple(c.reshape(FP.L, 2, n) for c in pt)  # noqa: E731
        if name == "g2_double":
            return (lambda: flat(cv.g2_double(view(p))),
                    lambda: chunked(torch, cv.g2_double_plain, (p,), n),
                    6 * FP2_BYTES * n, G2_DBL_OPS * n)
        if name == "g2_add":
            return (lambda: flat(cv.g2_add(view(p), view(q))),
                    lambda: chunked(torch, cv.g2_add_plain, (p, q), n),
                    9 * FP2_BYTES * n, G2_ADD_OPS * n)
        return (lambda: flat(cv.g2_madd(view(p), view(qa))),
                lambda: chunked(torch, cv.g2_madd_plain, (p, qa), n),
                8 * FP2_BYTES * n, G2_MADD_OPS * n)
    if name in ("miller_loop", "final_exp"):
        from kzg_torch.ops import pairing as pr

        n = shape[-1]
        p, q = pairing_case(ctx, n)
        if name == "miller_loop":
            return (lambda: pr.miller_loop(p, q), lambda: pr.miller_loop_plain(p, q),
                    (2 * FP_BYTES + 2 * FP2_BYTES + FP12_BYTES) * n, MILLER_OPS * n)
        f = ctx.rand_field(FP, 12 * n).view(FP.L, 2, 3, 2, n)
        f[..., -1] = 0  # an infinity lane's Miller value
        return (lambda: pr.final_exponentiation(f), lambda: pr.final_exponentiation_plain(f),
                2 * FP12_BYTES * n, (FEXP_OPS + ladder_ops(FP)) * n)
    if name == "dbl_chain":
        steps = spec[2]
        n = math.prod(shape[1:])
        p = special_points(ctx, n)[0]
        return (lambda: cv.dbl_chain(p, steps),
                lambda: chunked(torch, lambda *q: cv.dbl_chain_plain(q, steps), p, n),
                6 * FP_BYTES * n, steps * G1_DBL_OPS * n)
    raise ValueError(f"no replay for {spec}")


def replay_one(ctx, spec, count):
    """One distinct call: (launches per call, ms, plain_ms, max error, bytes,
    operations)."""
    from kzg_torch.ops import _build

    name = spec[0]
    kern, plain, n_bytes, n_ops = replay_case(ctx, spec)
    before = _build.LAUNCHES[name]
    got = kern()
    per_call = _build.LAUNCHES[name] - before
    plain_ms, want = ctx.time_once(plain)
    err = check(ctx, f"{name} {spec[1:]} x{count}", got, want)
    ms = ctx.time_cuda(kern)
    print(f"    {ms:.4f} ms kernel, {plain_ms:.1f} ms plain per call", flush=True)
    return per_call, ms, plain_ms, err, n_bytes, n_ops


def phase_replay(ctx, label, launches, calls, done):
    """Per kernel of the path: ms, plain_ms, bytes and operations summed over
    its logged calls (each distinct call replayed once, weighted by its
    count; a call an earlier path made too is taken from ``done``). The
    launches the replays make per call, times the counts, must add up to the
    path's own launches: the log missed no call."""
    totals, seen = {}, collections.Counter()
    for spec, count in sorted(calls.items(), key=lambda kv: (kv[0][0], str(kv[0]))):
        name = spec[0]
        if spec not in done:
            done[spec] = replay_one(ctx, spec, count)
        per_call, ms, plain_ms, err, n_bytes, n_ops = done[spec]
        seen[name] += per_call * count
        t = totals.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0,
                                     "err": 0, "calls": 0})
        t["ms"] += ms * count
        t["plain_ms"] += plain_ms * count
        t["bytes"] += n_bytes * count
        t["ops"] += n_ops * count
        t["err"] = max(t["err"], err)
        t["calls"] += count
    if {k: v for k, v in seen.items() if v} != {k: v for k, v in launches.items() if v}:
        raise AssertionError(f"{label}: the logged calls make {dict(seen)} launches, "
                             f"the path made {launches}")
    for name, t in totals.items():
        b, by = bound_ms(t["bytes"], t["ops"])
        t.update(launches=launches[name], bound_ms=b, bound_by=by)
        print(f"  {label}: {name}: {t['calls']} calls, {t['launches']} launches, "
              f"{t['ms']:.4f} ms kernel, {t['plain_ms']:.1f} ms plain, bound {b:.4f} ms ({by})",
              flush=True)
    return totals


def _checked_lanes(ctx, n: int):
    """The lanes of an n-lane ladder call that its plain check covers: all up
    to 2 MUL_PLAIN_LANES, else the first and last MUL_PLAIN_LANES (the lanes
    are independent)."""
    idx = ctx.torch.arange(n, device=ctx.device)
    if n > 2 * MUL_PLAIN_LANES:
        idx = ctx.torch.cat([idx[:MUL_PLAIN_LANES], idx[-MUL_PLAIN_LANES:]])
    return idx


def check_ladders(ctx, group, calls, mode_b: bool):
    """calls: Mode A (label, (x, y), k, inf, out) or Mode B (label, k, out),
    out a ladder kernel's output on those inputs. One plain call of the
    mode (naf_ladder_plain, gen_ladder_plain) over the checked lanes of
    every call side by side (_checked_lanes), each call held to its slice,
    bit-identical. The plain version's cost is its steps, not its lanes
    (tens of seconds a Mode A call on the card), hence one call. Returns
    (its ms, {label: max word error})."""
    torch = ctx.torch
    from kzg_torch.ops import curve as cv

    parts, cuts, lo = [], [], 0
    for label, *inputs, out in calls:
        if mode_b:
            (k,) = inputs
            idx = _checked_lanes(ctx, k.shape[1])
            parts.append((k[:, idx],))
        else:
            (x, y), k, inf = inputs
            n = x.shape[-1]
            idx = _checked_lanes(ctx, n)
            flags = inf[idx] if inf is not None else torch.zeros_like(idx, dtype=torch.bool)
            plus, minus = cv.naf_masks(k, n, ctx.device)
            parts.append((x[..., idx], y[..., idx], plus[:, idx], minus[:, idx], flags))
        cuts.append((label, lo, idx, out))
        lo += idx.numel()
    cat = [torch.cat([p[j] for p in parts], -1) for j in range(len(parts[0]))]
    if mode_b:
        plain = lambda: cv.gen_ladder_plain(cat[0], group)  # noqa: E731
    else:
        plain = lambda: cv.naf_ladder_plain(cat[:2], *cat[2:], group=group)  # noqa: E731
    plain_ms, want = ctx.time_once(plain)
    print(f"  {group.name}'s plain {'generator ' if mode_b else ''}ladder over {lo} lanes: "
          f"{plain_ms:.1f} ms", flush=True)
    errs = {}
    for label, start, idx, out in cuts:
        errs[label] = check(ctx, label, tuple(c[..., idx] for c in out),
                            tuple(c[..., start : start + idx.numel()] for c in want))
    return plain_ms, errs


def ladder_case(ctx, spec):
    """Seeded inputs at a logged ladder call's shape. Mode A: canonical words
    for the affine base, the call's public scalar on every lane or seeded
    scalars below r, every 61st lane flagged where the call had a mask;
    returns ((x, y), k, inf) and the live lanes' scalars as ints. Mode B:
    seeded scalars below r; returns (k,) and the scalars."""
    torch = ctx.torch
    from kzg_torch.ops import limbs as lb
    from kzg_torch.ops.field import FP, FR

    if spec[0] in MODE_B:
        k = ctx.rand_field(FR, spec[1][1])
        return (k,), lb.words_to_ints(k)
    _, shape, public, masked = spec
    n = shape[-1]
    x, y = (ctx.rand_field(FP, math.prod(shape[1:])).view(shape) for _ in range(2))
    inf = torch.arange(n, device=ctx.device) % 61 == 5 if masked else None
    if public is not None:
        return ((x, y), public, inf), [public] * (n - (int(inf.sum()) if masked else 0))
    k = ctx.rand_field(FR, n)
    return ((x, y), k, inf), lb.words_to_ints(k if inf is None else k[:, ~inf])


def mul_edge_calls(ctx, group) -> list:
    """The group's Mode A kernel on the case table of
    kzg_torch/utils/mul_cases.py at MUL_CHECK_SIZES (n = 1, 9, 127, 128,
    129 and 2^16): mul_scalar_affine on affine_case (k = 0, 1, r - 1,
    2^256 - 1, r (acc == -P at the last step), r + 2, r - 2 (acc == -P and
    digit -1: the exact madd doubles) and SPLIT_DOUBLE on lanes 0-7, r - 2
    on three lanes of warp 1; seeded words and scalars elsewhere) and
    mul_scalar(p, r) on public_case (a subgroup point, infinity, a point
    outside the subgroup, a second subgroup point, and G1's point of order
    3 (acc meets P, -P and infinity) or G2's off-subgroup point negated; Z
    one elsewhere), the case lanes against the host oracles. Returns the
    calls for check_ladders."""
    from kzg_torch.ops import curve as cv
    from kzg_torch.utils import mul_cases

    calls = []
    for n in MUL_CHECK_SIZES:
        (x, y), k, base = mul_cases.affine_case(group, n, SEED + n, ctx.device)
        out = cv.mul_scalar_affine((x, y), k, group=group)
        lanes = sorted(base)
        want = mul_cases.affine_oracle(group, base)
        if group.host_affine(*group.to_affine(tuple(c[..., lanes] for c in out))) != [
                want[lane] for lane in lanes]:
            raise AssertionError(f"{group.name} ladder (n={n}): a case lane differs from the "
                                 f"host oracle")
        calls.append((f"{group.name} ladder, a scalar a lane (n={n}, the case table)", (x, y),
                      k, None, out))
        p, pts = mul_cases.public_case(group, n, SEED + n + 1, ctx.device)
        out = cv.mul_scalar(p, mul_cases.PUBLIC, group=group)
        got = group.host_affine(*group.to_affine(tuple(c[..., : len(pts)] for c in out)))
        if got != mul_cases.public_oracle(group, pts):
            raise AssertionError(f"{group.name} [r] P (n={n}): a case lane differs from the "
                                 f"host oracle")
        calls.append((f"{group.name} [r] P (n={n}, the case table)", (p[0], p[1]),
                      mul_cases.PUBLIC, group.is_inf(p), out))
    return calls


def gen_edge_calls(ctx, group) -> list:
    """The group's Mode B kernel on mul_cases.gen_case at MUL_CHECK_SIZES:
    the scalars 0, 1, r - 1, 2^256 - 1, r (the pieces' last level adds -Q
    to Q), r + 2, r - 2 and SPLIT_DOUBLE (the last level doubles) on lanes
    0-7, seeded 256-bit scalars elsewhere, not reduced; the case lanes
    against [k mod r] G. Returns the calls for check_ladders."""
    from kzg_torch.utils import mul_cases

    calls = []
    for n in MUL_CHECK_SIZES:
        k = mul_cases.gen_case(n, SEED + n + 2, ctx.device)
        out = group.gen_ladder(k)
        lanes = range(min(n, len(mul_cases.SCALARS)))
        got = group.host_affine(*group.to_affine(tuple(c[..., : len(lanes)] for c in out)))
        if got != mul_cases.gen_oracle(group, k, lanes):
            raise AssertionError(f"{group.name} [k] G (n={n}): a case lane differs from the "
                                 f"host oracle")
        calls.append((f"{group.name} [k] G (n={n}, the case table)", k, out))
    return calls


def phase_ladders(ctx, paths, done):
    """The ladder kernels, a group and a mode at a time: every distinct call
    the paths logged, replayed at its shape on ladder_case's inputs,
    launched once (its launches a call), timed by CUDA events, bounded by
    mul_cost (Mode A) or gen_cost (Mode B), its chain counted by mul_chain
    or gen_chain; then the mode's case table (mul_edge_calls,
    gen_edge_calls). Every one of those calls is held to one plain call of
    the mode over their checked lanes side by side (check_ladders); a
    replayed call's plain_ms is that plain call's. Fills ``done`` as
    replay_one does."""
    from kzg_torch.ops import _build
    from kzg_torch.ops import curve as cv
    from kzg_torch.utils import hostmath as hm

    specs = sorted({spec for _, calls in paths.values() for spec in calls
                    if spec[0] in LADDERS}, key=str)
    for name, group in zip(LADDERS, (cv.G1, cv.G2, cv.G1, cv.G2)):
        mode_b = name in MODE_B
        launch = group.gen_ladder if mode_b else group.ladder
        rows, calls = {}, []
        for spec in (sp for sp in specs if sp[0] == name):
            inputs, ints = ladder_case(ctx, spec)
            before = _build.LAUNCHES[name]
            out = launch(*inputs)
            per_call = _build.LAUNCHES[name] - before
            ms = ctx.time_cuda(lambda: launch(*inputs))
            if mode_b:
                ctx.ladder_chains[spec] = gen_chain(ints)
                if sum(ctx.ladder_chains[spec].values()) > MAX_GEN_CHAIN:
                    raise AssertionError(f"{name}: a chain of {ctx.ladder_chains[spec]}")
                rows[spec] = (per_call, ms, *gen_cost(ints, spec[1][1], group is cv.G2))
                label = f"{name} {spec[1]}"
            else:
                ctx.ladder_chains[spec] = mul_chain(ints)
                if spec[2] == hm.R and ctx.ladder_chains[spec] != R_CHAIN:
                    raise AssertionError(f"{name}: [r] P's chain {ctx.ladder_chains[spec]}")
                rows[spec] = (per_call, ms, *mul_cost(ints, spec[1][-1], spec[3],
                                                      group is cv.G2))
                label = (f"{name} {spec[1]}, "
                         f"{'a scalar a lane' if spec[2] is None else 'one scalar'}"
                         f"{', masked' if spec[3] else ''}")
            calls.append((label, *inputs, out))
            print(f"  {label}: {ms:.4f} ms kernel, chain {ctx.ladder_chains[spec]}", flush=True)
        edges = gen_edge_calls(ctx, group) if mode_b else mul_edge_calls(ctx, group)
        plain_ms, errs = check_ladders(ctx, group, calls + edges, mode_b)
        for (spec, (per_call, ms, n_bytes, n_ops)), call in zip(rows.items(), calls):
            done[spec] = (per_call, ms, plain_ms, errs[call[0]], n_bytes, n_ops)


def phase_stream_scan(ctx, calls):
    """The streaming scan (K3's every-prefix entry, the function of K3a-d and
    K6) runs on no path: checked in both modes against its plain version at
    the shape the fused scan ran on the main path (m steps over C chunks),
    and timed in turns on one stream (fast, exact, exact, fast). Returns its
    kernels-line entry (the fast mode's numbers) and both modes' times."""
    from kzg_torch.ops import scans
    from kzg_torch.ops.field import FP

    spec = next(spec for spec in calls if spec[0] == "scan_buckets")
    P, m = spec[2][0], spec[3]
    C = P // m
    xs = ctx.rand_field(FP, m * C).view(FP.L, m, C).permute(1, 0, 2)
    ys = ctx.rand_field(FP, m * C).view(FP.L, m, C).permute(1, 0, 2)
    fast = lambda: scans.scan_prefix_madd(xs, ys, fast=True)  # noqa: E731
    exact = lambda: scans.scan_prefix_madd(xs, ys, fast=False)  # noqa: E731
    fast_plain_ms, want = ctx.time_once(lambda: scans.scan_prefix_madd_plain(xs, ys, True))
    err = check(ctx, f"scan_madd fast {(m, FP.L, C)}", fast(), want)
    exact_plain_ms, want = ctx.time_once(lambda: scans.scan_prefix_madd_plain(xs, ys, False))
    err = max(err, check(ctx, f"scan_madd exact {(m, FP.L, C)}", exact(), want))
    del want
    t = [ctx.time_cuda(f, reps=3) for f in (fast, exact, exact, fast)]
    print(f"  scan_madd at {(m, FP.L, C)}: fast {t[0]:.3f} / {t[3]:.3f} ms, exact {t[1]:.3f} / "
          f"{t[2]:.3f} ms, plain fast {fast_plain_ms:.1f} / exact {exact_plain_ms:.1f} ms",
          flush=True)
    b, by = bound_ms(5 * FP_BYTES * m * C, G1_MADD_OPS * m * C)
    entry = {"ms": (t[0] + t[3]) / 2, "plain_ms": fast_plain_ms, "err": err, "calls": 1,
             "launches": 0, "bound_ms": b, "bound_by": by, "shape": str(((m, FP.L, C), "fast"))}
    return entry, {"fast_ms": (t[0] + t[3]) / 2, "exact_ms": (t[1] + t[2]) / 2,
                   "fast_plain_ms": fast_plain_ms, "exact_plain_ms": exact_plain_ms}


def phase_off_path(ctx):
    """K8 and K7 have no caller on a path (the JAX package's callers are its
    tests and a bench): each is checked against its plain version and timed
    at fixed shapes, K8 at the ceremony's fold shape, K7 at the bench's
    (128 lanes, 5 steps) and at 2^16 lanes and 16 steps, the one reported.
    K9's doubling has had none since the ladder kernels: it is checked and
    timed at 2^16 lanes, the G2 subgroup check's shape before them.
    Then the field multiply's two probes, at shapes any checkout's table
    build has run, so that two checkouts' runs compare the header: K1 at
    2^24 Fp lanes and K2's doubling at 2^20 lanes (reported beside, not in,
    their kernels' rows); and K9's madd at 2^16 lanes, 1.94 waves of its
    blocks (the 2^16 setup's path runs chunks of 8192 lanes, under one
    wave). The Fr inversion has no caller on a path either: it is checked
    and timed at 2^20 lanes."""
    from kzg_torch.ops.field import FP, FR

    out, extra = {}, {}
    for spec in (("fold_entries", (32, FP.L, SRS_CHUNK)), ("inv_batch_fr", (FR.L, 1 << LOG_N)),
                 ("dbl_chain", (FP.L, 128), 5),
                 ("dbl_chain", (FP.L, CHECK_LANES), DBL_STEPS),
                 ("g2_double", (FP.L, 2, 1 << LOG_SETUP)),
                 ("mont_mul_fp", (FP.L, 1 << 24)), ("g1_double", (FP.L, 1 << LOG_N)),
                 ("g2_madd", (FP.L, 2, 1 << LOG_SETUP))):
        kern, plain, n_bytes, n_ops = replay_case(ctx, spec)
        plain_ms, want = ctx.time_once(plain)
        err = check(ctx, f"{spec[0]} {spec[1:]}", kern(), want)
        ms = ctx.time_cuda(kern)
        b, by = bound_ms(n_bytes, n_ops)
        print(f"    {ms:.4f} ms kernel, {plain_ms:.1f} ms plain, bound {b:.4f} ms ({by})",
              flush=True)
        entry = {"ms": ms, "plain_ms": plain_ms, "err": err, "calls": 1, "launches": 0,
                 "bound_ms": b, "bound_by": by, "shape": str(spec[1:])}
        if spec[0] in ("mont_mul_fp", "g1_double", "g2_madd"):
            extra[f"{spec[0]} {entry['shape']}"] = entry
            continue
        if spec[0] in out:
            extra[f"{spec[0]} {out[spec[0]]['shape']}"] = out[spec[0]]
        out[spec[0]] = entry
    return out, extra


def adjacent_tree_widths(n: int) -> list:
    """The lanes of each add a tree_reduce_adjacent over n lanes makes."""
    widths = []
    while n > 1:
        widths.append(n // 2)
        n -= n // 2
    return widths


def phase_batched_route(ctx, calls):
    """The route K2b replaced, at the batched path's MSM shape (n lanes):
    K2's double and exact madd at n lanes (256 calls each) and its add at
    each level's width, each checked against its plain version and timed,
    summed per kernel (K2's double and add rows: no path launches them).
    Returns the double and add rows, and the madd's totals."""
    from kzg_torch.ops.field import FP

    n = next(spec for spec in calls if spec[0] == "ladder_msm")[1][1]
    rows = {}
    for name, specs in (("g1_double", [("g1_double", (FP.L, n))] * 256),
                        ("g1_madd", [("g1_madd", (FP.L, n), False)] * 256),
                        ("g1_add", [("g1_add", (FP.L, h)) for h in adjacent_tree_widths(n)])):
        t = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "err": 0,
             "calls": len(specs), "launches": 0}
        for spec, count in collections.Counter(specs).items():
            kern, plain, n_bytes, n_ops = replay_case(ctx, spec)
            plain_ms, want = ctx.time_once(plain)
            t["err"] = max(t["err"], check(ctx, f"{spec[0]} {spec[1:]} x{count}", kern(), want))
            t["ms"] += ctx.time_cuda(kern) * count
            t["plain_ms"] += plain_ms * count
            t["bytes"] += n_bytes * count
            t["ops"] += n_ops * count
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["ops"])
        t["shape"] = f"the batched route at n = {n}: {len(specs)} calls"
        print(f"  {name} at the batched route's shapes: {len(specs)} calls, {t['ms']:.4f} ms "
              f"kernel, {t['plain_ms']:.1f} ms plain, bound {t['bound_ms']:.4f} ms", flush=True)
        rows[name] = t
    return rows, {f: v for f, v in rows.pop("g1_madd").items() if f != "err"}


def phase_ladder_edges(ctx):
    """K2b on the exceptional lanes of kzg_torch/utils/ladder_cases.py at
    the paths' n = 10 and 8192 and at 129 (a partial block; points base_i G
    from K2's ladder), unmasked and with lanes 3 and n - 1 flagged infinite:
    against msm_batched_plain and that route on K2's kernels
    (bit-identical), and against the host oracle (sum base_i k_i) G1."""
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import msm
    from kzg_torch.utils import hostmath as hm
    from kzg_torch.utils.ladder_cases import edge_lanes, oracle, scalar_words

    rnd = random.Random(SEED + 2)
    for n in LADDER_CHECK_SIZES:
        base = [rnd.randrange(2, hm.R) for _ in range(n)]
        (x, y), _ = cv.to_affine(cv.mul_scalar_affine(cv.g1_gen_affine(ctx.device, n),
                                                      scalar_words(base, ctx.device)))
        ks = [rnd.randrange(hm.R) for _ in range(n)]
        mask = edge_lanes(x, y, base, ks)
        k = scalar_words(ks, ctx.device)
        for m in (None, mask):
            label = f"ladder_msm (n={n}{', lanes 3 and n - 1 infinite' if m is not None else ''})"
            got = msm.msm_batched_affine((x, y), k, m)
            check(ctx, label, got, msm.msm_batched_plain((x, y), k, m))
            check(ctx, f"{label}, the same route on K2's kernels", got, msm.msm_batched_plain(
                (x, y), k, m, add=cv.g1_add, madd=cv.g1_madd, double=cv.g1_double))
            if cv.g1_from_device(tuple(c[:, None] for c in got)) != oracle(base, ks, m):
                raise AssertionError(f"{label}: differs from the host oracle")


def phase_g2_edges(ctx):
    """K9 against its plain version on the case table of
    kzg_torch/utils/g2_cases.py (p, q or both at infinity, P == Q in other
    and in the same words, P == -Q, p at infinity with X and Y not zero,
    madd's first lane at infinity) at n = 1, 127, 128 and 129, the case
    lanes also against the host oracle. The paths' shapes are the
    replays'."""
    from kzg_torch.ops import curve as cv
    from kzg_torch.utils import g2_cases

    for n in G2_CHECK_SIZES:
        p, q, qa = g2_cases.case_points(n, SEED + n, ctx.device)
        for op, kern, plain in (("double", cv.g2_double, cv.g2_double_plain),
                                ("add", cv.g2_add, cv.g2_add_plain),
                                ("madd", cv.g2_madd, cv.g2_madd_plain)):
            args = (p,) if op == "double" else (p, q if op == "add" else qa)
            got = kern(*args)
            check(ctx, f"g2_{op} (n={n}, the case table)", got, plain(*args))
            m = min(n, g2_cases.CASE_LANES)
            aff = cv.g2_from_device(tuple(c[..., :m] for c in got))
            for lane, want in g2_cases.oracle(SEED + n, op).items():
                if lane < m and aff[lane] != want:
                    raise AssertionError(f"g2_{op} (n={n}): {g2_cases.CASES[lane]} differs "
                                         f"from the host oracle")


def phase_pairing_edges(ctx):
    """K10 and K11 against their plain versions (bit-identical) at n = 1,
    2, 33 and 128 lanes: lane 0 the generator pair, the last lane (n > 1)
    an infinity lane of zero words, the others seeded pairs s G1, t G2 (the
    ladders on K2 and K9); K11 on those lanes' Miller values and one lane
    of random Fp12 words; lane 0's pairing against hostmath. Each kernel
    launches once a size; its plain version, whose cost is its launches and
    not its lanes (about 9 s a call on the card), runs once over every
    size's lanes side by side, and each launch is held to its slice."""
    torch = ctx.torch
    from kzg_torch.ops import curve as cv
    from kzg_torch.ops import fp12
    from kzg_torch.ops import pairing as pr
    from kzg_torch.ops.field import FP
    from kzg_torch.utils import hostmath as hm

    rnd = random.Random(SEED + 7)
    total = sum(PAIRING_CHECK_SIZES)
    k1, k2 = (cv.fr_std_words([rnd.randrange(1, hm.R) for _ in range(total)], ctx.device)
              for _ in range(2))
    (x1, y1), _ = cv.to_affine(cv.mul_scalar_affine(cv.g1_gen_affine(ctx.device, total), k1))
    (x2, y2), _ = cv.g2_to_affine(cv.mul_scalar_affine(cv.g2_gen_affine(ctx.device, total), k2,
                                                       group=cv.G2))
    coords = (x1, y1, x2, y2)
    gens = cv.g1_gen_affine(ctx.device) + cv.g2_gen_affine(ctx.device)
    cuts, lo = [], 0
    for n in PAIRING_CHECK_SIZES:
        for c, g in zip(coords, gens):
            c[..., lo : lo + 1] = g
            if n > 1:
                c[..., lo + n - 1] = 0
        cuts.append((n, lo))
        lo += n
    want_f = pr.miller_loop_plain((x1, y1), (x2, y2))
    fs = []
    for n, lo in cuts:
        seg = tuple(c[..., lo : lo + n].contiguous() for c in coords)
        f = pr.miller_loop(seg[:2], seg[2:])
        check(ctx, f"miller_loop (n={n}, the generators, an infinity lane, seeded pairs)", f,
              want_f[..., lo : lo + n])
        fs.append(torch.cat([f, ctx.rand_field(FP, 12).view(FP.L, 2, 3, 2, 1)], dim=-1))
    want_g = pr.final_exponentiation_plain(torch.cat(fs, dim=-1).contiguous())
    e_gen = hm.pairing(hm.G1_GEN, hm.G2_GEN)
    lo = 0
    for f in fs:
        n = f.shape[-1]
        g = pr.final_exponentiation(f.contiguous())
        check(ctx, f"final_exp (n={n}, those Miller values and random words)", g,
              want_g[..., lo : lo + n])
        if fp12.to_ints(g[..., 0]) != e_gen:
            raise AssertionError("final_exp(miller_loop(G1, G2)) differs from hostmath.pairing")
        lo += n


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "kzg_torch", "csrc")):
        return fail("kzg_torch/ is not beside this script")
    sys.path.insert(0, here)
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    print("== device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else None
    if card is None:
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from kzg_torch.ops import _build

    print("== build", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    print(f"  built {_build.library_path().name} in {time.perf_counter() - t0:.1f} s", flush=True)
    usage = _build.ptxas_usage()
    for fn, u in sorted(usage.items()):
        print(f"  ptxas {fn}: {u['registers']} registers, {u['spill_stores']} / "
              f"{u['spill_loads']} bytes spill stores / loads, {u['smem']} bytes smem", flush=True)
    missing = sorted({f for fns in DEVICE_FUNCTIONS.values() for f in fns} - set(usage))
    if missing:
        return fail(f"no -Xptxas -v report for {missing}")

    ctx = Ctx(torch, device)
    gc.callbacks.append(ctx.gc_callback)
    print("== kernels, exceptional cases", flush=True)
    phase_kernels(ctx)
    print("== paths", flush=True)
    paths, times, commit = phase_paths(ctx)
    per_path, done = {}, {}
    print("== the ladder kernels: every path's calls replayed, then mul_cases.py's cases",
          flush=True)
    phase_ladders(ctx, paths, done)
    for label, (launches, calls) in paths.items():
        print(f"== replay: {label}", flush=True)
        per_path[label] = phase_replay(ctx, label, launches, calls, done)
    print("== the kernels no path launches (K8, K7, the Fr inversion), and the multiply's probes",
          flush=True)
    off_path, times["off_path_other_shapes"] = phase_off_path(ctx)
    print("== K2's batched route, the one K2b replaced, at the batched commit's shapes",
          flush=True)
    route_rows, times["k2_madd_at_batched_shape"] = phase_batched_route(ctx, paths[BATCHED][1])
    off_path.update(route_rows)
    print("== the streaming scan, both modes, at the main path's scan shape", flush=True)
    off_path["scan_madd"], times["scan_modes"] = phase_stream_scan(ctx, paths[MAIN][1])
    # last, so that no timing above runs after the profiler
    print("== profile: one warm 2^20 commit", flush=True)
    times["profile"] = phase_profile(ctx, commit)
    print("== the proof's evaluation and division, exceptional cases", flush=True)
    phase_poly_kernels(ctx)
    print("== the bucket reduction, exceptional cases", flush=True)
    spec = next(spec for spec in paths[MAIN][1] if spec[0] == "bucket_reduce")
    phase_reduce_edges(ctx, spec[2][1])
    print("== the batched MSM (K2b), exceptional cases", flush=True)
    phase_ladder_edges(ctx)
    print("== G2's point formulas (K9), exceptional cases", flush=True)
    phase_g2_edges(ctx)
    print("== the pairing's Miller loop (K10) and final exponentiation (K11), edge lanes",
          flush=True)
    phase_pairing_edges(ctx)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        # each kernel's numbers come from the first of these paths that runs it;
        # its launches on every path stand beside them
        label = next((lb for lb in (MAIN, CEREMONY, PROOF, BATCHED, REF, SETUP, LOAD,
                                    DECOMPRESS, SETUP_REF, VERIFY) if name in per_path[lb]),
                     None)
        if label is None and name not in off_path:
            return fail(f"{name} was launched on no path")
        t = per_path[label][name] if label is not None else off_path[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": t["launches"], "max_abs_err": t["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "path": label or f"none: timed at {t['shape']}",
            "calls": t["calls"],
            "registers": max(usage[f]["registers"] for f in DEVICE_FUNCTIONS[name]),
            "spill_bytes": max(usage[f]["spill_stores"] + usage[f]["spill_loads"]
                               for f in DEVICE_FUNCTIONS[name]),
            "stack_bytes": max(usage[f]["stack"] for f in DEVICE_FUNCTIONS[name]),
            "launches_by_path": {lb: paths[lb][0].get(name, 0) for lb in paths},
        })
        if name == "bucket_reduce":
            chain = sum(BUCKET_REDUCE_CHAIN.values())
            kernels[-1]["critical_path"] = dict(BUCKET_REDUCE_CHAIN, ms_per_op=t["ms"] / chain)
            print(f"  bucket_reduce: {t['ms']:.4f} ms over a critical path of "
                  f"{BUCKET_REDUCE_CHAIN['adds']} dependent adds and "
                  f"{BUCKET_REDUCE_CHAIN['doubles']} doublings, {t['ms'] / chain * 1e3:.1f} us a "
                  f"point operation", flush=True)
        if name in PAIRING_CHAINS:
            chain = PAIRING_CHAINS[name]
            kernels[-1]["critical_path"] = dict(chain, ms_per_fp12_op=t["ms"] / chain["fp12_ops"])
            batch = per_path[VERIFY_BATCH][name]
            kernels[-1]["at_verify_batch"] = {f: batch[f] for f in ("ms", "plain_ms", "bound_ms",
                                                                    "calls", "launches")}
            print(f"  {name}: {t['ms']:.4f} ms over a chain of {chain['fp12_ops']} dependent "
                  f"Fp12 operations, {t['ms'] / chain['fp12_ops'] * 1e3:.1f} us each; at "
                  f"{VERIFY_BATCH}: {batch['ms']:.4f} ms", flush=True)
        if name in LADDERS:
            # every path's call: a few lanes run one thread's (Mode B: one lane's)
            # chain, 2^16-2^20 fill the card
            kernels[-1]["by_path"] = {}
            for lb in paths:
                spec = next((sp for sp in paths[lb][1] if sp[0] == name), None)
                if spec is None:
                    continue
                row, chain = per_path[lb][name], ctx.ladder_chains[spec]
                ops = sum(chain.values())
                kernels[-1]["by_path"][lb] = dict(
                    {f: row[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "launches")},
                    lanes=spec[1][-1], chain=chain, us_per_op=row["ms"] / max(ops, 1) * 1e3)
                print(f"  {name} at {lb}: {row['ms']:.4f} ms at {spec[1][-1]} lanes, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_ms'] / row['ms']:.1%}), chain "
                      f"{chain}, {row['ms'] / max(ops, 1) * 1e3:.2f} us a point operation",
                      flush=True)
        if name == "ladder_msm":
            spec = next(spec for spec in paths[label][1] if spec[0] == name)
            ladder_chain_run = ctx.ladder_chains[spec]
            ops = sum(ladder_chain_run.values())
            kernels[-1]["critical_path"] = dict(ladder_chain_run, ms_per_op=t["ms"] / ops)
            print(f"  ladder_msm: {t['ms']:.4f} ms over a critical path of "
                  f"{ladder_chain_run['doubles']} doublings, {ladder_chain_run['madds']} madds "
                  f"and {ladder_chain_run['adds']} adds, {t['ms'] / ops * 1e3:.2f} us a point "
                  f"operation", flush=True)
    times["gc_ms_by_path"] = ctx.path_gc_ms
    print(json.dumps({"slice_ms": times, "card": card,
                      "paths": {lb: {k: {f: v for f, v in t.items() if f != "err"}
                                     for k, t in tot.items()}
                                for lb, tot in per_path.items()}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
