#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py            # flat and ADC paths at SIFT1M scale
                                     # (n = 1M), graph path at n = 50,000
    python3 chip_smoke.py --graph-n 20000 --n 20000 --queries 64  # quick

Phases, each of which fails the run (non-zero exit, no final line):

1. Device and build: the card's name and power limit, the torch and
   CUDA versions, and the build of the CUDA kernels from
   `src/repro_torch/csrc/` (with nvcc's register and spill report).
   Then the graph path's corpus is made and encrypted on the card, and
   the owner's HNSW build over it (host numpy, minutes at 50k rows)
   starts in a worker process, so it runs while phases 2 to 4 use the
   card, beside four more workers building phase 8's per-shard
   subgraphs; 1,000 more rows of the same mixture are encrypted with the
   same keys for phase 6's graph inserts.  Phase 3's corpus is made and
   encrypted here too, and a sixth worker trains phase 4's pq8 codebook
   over it and encodes the rows (host numpy, ~9 min at 1M rows), which
   the pq8 engine then takes instead of training at its attach.  And
   phase 11's dry run starts in the background on the host
   (`python -m repro_torch.launch.dryrun --all --both-meshes --mesh
   1card_h100`, niced, 4 cells at a time; meta tensors, no card).
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the main paths give them, with times (CUDA events), bounds
   and a library yardstick where one PyTorch call computes the same
   function.  Tolerances:
     l2_topk.knn (the flat filter's fused scan + top-k'; 1% of rows
     duplicated, so exact ties occur): ids equal to the plain chunked
     merge in >= 99.9% of slots, distances within 1e-5 * (||q||^2 +
     ||x||^2) where the ids agree (fp32 sums in another order);
     dce_comp.refine_topk (the fused refine, on real DCE ciphertexts
     read through a shuffled cand, ~10% of slots invalid): win counts
     equal to those of the Z entry exactly (one main loop), and wins and
     ids equal to the plain version wherever every pair has |Z_plain| >
     1e-5 * max|Z| (the rest is reported);
     sq_adc_topk / pq_adc_topk (quantized scan + top-kp): ids and
     distances exactly equal (int32 surrogates; float32 sums taken in
     the same subspace order), exhausted slots included; an `adc_split`
     line before each of their records splits the call's device time
     into scan, selection and merge (torch.profiler by kernel; the scan
     alone is the same call with every row masked);
     sq_encode_queries (K4's query operand quantized on the card, nq
     1024 and 32 at d 128 and 960): codes bit-equal to numpy's
     `SQCodebook.encode_query` and to the plain version;
     l2 tiles: |kernel - plain| <= 1e-5 * (||q||^2 + ||x||^2);
     Z tiles:  |kernel - plain| <= 1e-5 * max|Z|, and equal signs
               wherever |Z_plain| > 1e-5 * max|Z|;
     both because the hand kernel and cuBLAS sum in different orders in
     true fp32.
     graph_expand.graph_walk (the fused walk: upper-layer descent and
     layer-0 beam search, one launch) on synthetic graphs with upper
     layers (3 of them empty padded layers) at R 2^17 / M0 16, R 2^20 /
     M0 32, d 960, R 2^21 (the visited bitmap in device memory) and
     ef_cap 2048, and graph_expand.expand_layer0 (its layer-0 entry) at
     its three shapes, over a random adjacency (some -1 slots, some rows
     with ok = 0) and integer-valued rows, so every distance is exact in
     both summation orders: ids, distances, visited words, hops and
     edges bit-equal to the torch walk's;
     dce_comp.z_matrix (K3, its column tiles split over more blocks):
     within the Z tolerance of the plain version, and bit-equal to the
     batched entry's Z of the same set;
     the fused top-k scans also at k' 1600 (two passes of 800 each);
     16-bit rows read in place (bf16 and f16): l2_topk.knn at nq 32 x 1M
     x d 128, k' 80 and dce_comp.refine_topk at B 32 x n 80 / 320, D 272
     (rows and queries / trapdoors rounded to 16 bits), each held to
     its plain version with the tolerances above and bit-equal (ids,
     distances, wins) to the float32 kernel on float32 copies of the
     same values; the library yardsticks upcast in the call; and, on no
     path, the tile entry (nq 32, n 4096, d 128) and the Z entry (n 512
     and 640, D 272: RI 2 and 3) on bf16 and f16 rows, held the same two
     ways.  A record whose
     shape no path runs (the f16 rows, K2 at n 320 in 16 bits) reports 0
     launches on no path.
3. The flat path: a synthetic SIFT-width corpus (clustered Gaussians)
   encrypted on the card by `DataOwner.encrypt_vectors`, queries
   encrypted by `User`, and `SecureSearchEngine(backend="flat")` on the
   card answering them in batches of 32 (k = 10, k' = 80; one fused
   l2_topk.knn and one fused dce_comp.refine_topk call a batch), once
   through the kernels and once with the kernels swapped for their plain
   versions.  Final ids must agree in >= 99.9% of slots and recall@10
   within 0.005 (ulp-level near-ties at the k' boundary may flip).  Then
   4 batches at k = 200 (k' 1600, above the scan's 1024 a pass), kernels
   against plain versions (`k1600_path`).  A
   small database is also searched on the card and on the host (plain
   versions) from the numpy encryption, through the flat, IVF, ADC
   (int8 / pq8, flat / IVF) and ADC graph filters: the ids must agree
   as on the flat path.  Then the secure-scan step
   (`build_secure_scan_step_gspmd`, batches of 32, k' 80) over the same
   corpus with its four operands all float32, a bf16 filter (C_sap and
   Q bf16, the refine float32) and all bf16 (the reference's bf16
   cells), K1 and K2 reading the bf16 ones in place: recall@10 of
   each (`scan_forms` line); the float32 form's ids = the flat engine's
   in >= 99.9% of slots, the all-bf16 form's = the step's on float32
   copies of the bf16 values in every slot.
4. The ADC paths, after the flat engine is freed, on the same
   ciphertexts and queries: `SecureSearchEngine(backend="flat",
   quantization="int8" | "pq8")` (codebook trained on the host at
   attach, pq8's in phase 1's worker; sq_adc_topk or pq_adc_topk once
   per batch, refine_topk for the refine), each once through the
   kernels and once with them swapped for their plain versions on the
   same engine (same limits as the flat path), and each with 1600
   candidates (k = 100 int8, k = 50 pq8) as the flat path; and
   `backend="ivf", quantization="int8"` (64 partitions, nprobe 8), also
   against its plain versions.  The pq8 engine runs after phase 8, so
   phases 6-8 fill the wait for its codebook.
5. The graph path, after the ADC engines are freed (and after phases
   6 to 8):
   `SecureSearchEngine(backend=GraphFilter(index))` over the HNSW of
   phase 1 (M = 8, ef_construction = 48), the same batches, k = 10,
   ratio_k = 8, ef_search = 96: once through the kernels (one
   graph_walk and one refine_topk launch a batch, and no torch
   descent), once with both swapped for their plain versions (same
   limits as the flat path), and the per-query host walk
   (`HNSWGraphFilter`) on the first 64 queries.  `graph_breakdown`
   times the fused walk against the parent's torch descent and the
   layer-0 entry alone, and the scan trace's download.  Then every
   batch's walk again with C_SAP and the queries rounded to bf16 and to
   f16 (paths graph_bf16 and graph_f16, one graph_walk a batch): beams,
   distances, visited, hops and edges bit-equal to the float32 kernel on
   float32 copies, beam ids = the plain walk's on 4 batches (>= 99.9%).

6. The serving runtime (`serving/runtime`), run after phase 4's int8
   engines and before phase 5, on phase 3's ciphertexts and queries and
   phase 1's graph corpus and HNSW (nothing re-encrypted, no HNSW
   rebuilt), every
   collection keyless on the card and each freed before the next:
   (a) a flat collection under the flush micro-batcher (max_batch 32,
       2 ms): `load_snapshot` of rows 0..n-10,001, `warmup`, then 8 client
       threads submitting 128 queries each; their ids must equal the
       collection's direct `search_batch` in 100% of slots;
   (f) one more flush pass under `profile_kernels()`: calls and
       CUDA-event ms by kernel beside phase 2's device ms (report only);
   (b) live ingestion on (a): the 10,000 held-out rows in 10 bursts of
       1,000, a batch after each (two K1 calls a batch while the delta is
       non-empty), all queries (ids >= 99.9% equal to the same
       collection's with the kernels swapped for their plain versions),
       `compact()` (ids >= 99.9% equal to phase 3's flat ids), 1,000
       deletes (some of them ids of those answers: none may come back;
       plain ids again), and no kernel rebuild after warmup;
   (c) the same rows and operations under the continuous slot loop, each
       search through client threads: ids equal to (a)/(b)'s in 100% of
       slots at every checkpoint;
   (d) an int8 collection over the 1M rows with (b)'s deletes (K4 with
       the `ok` stream), and a pq8 collection over the graph corpus (K5),
       each against its plain run;
   (e) a graph collection over the graph corpus (`graph_arrays` = the
       HNSW's `to_arrays()`): 1% of its rows deleted, then the 1,000
       rows phase 1 held out inserted; ids against the plain torch walk
       after each, and no deleted id returned.
   One `runtime_path` line each; their launches join the `kernels` line
   as `launches_by_path` runtime_flat, runtime_flat_continuous,
   runtime_int8, runtime_pq8 and runtime_graph.
7. The public API (`repro_torch.api`) and the leakage harness
   (`repro_torch.sec.leakage`), run after phase 6 and before phase 5, on
   the ciphertexts the script already holds:
   (a) the three roles over phase 3's corpus: `DataOwnerClient` around
       phase 3's keys (`DataOwner.from_keys`), its keys exported to a
       keystore, `QueryClient.from_keystore(seed=17)` whose query
       ciphertexts must equal phase 3's byte for byte, and a keyless
       flat collection made from phase 3's ciphertexts; batch requests
       of 32 (each request and result through `to_bytes` /
       `from_bytes`) whose ids must equal phase 3's in 100% of slots,
       with one l2_topk.knn and one refine_topk launch each, then 8
       client threads submitting 128 coalesced single-query requests
       each, whose ids must equal the batch ids in 100% of slots;
   (b) persistence over phase 1's graph corpus: a graph collection (the
       owner's HNSW arrays) and a flat int8 collection, each searched,
       saved to a `.ppcol`, closed, loaded into a fresh service and
       searched again (ids equal in 100% of slots, no kernel build or
       load after the load), then one held-out row inserted and found
       and one answered id deleted and never returned;
   (c) the leakage harness at BENCH_attacks.json's replay scale (2,048
       rows, d 32, 64 queries): a graph collection's scan trace with the
       kernels bit-equal to its trace with their plain versions, then
       `evaluate_profile` for every profile x (ivf, ivf+int8, graph)
       and the bars of tests/test_leakage.py.
   One `api_path` line per collection and one `leakage` line; the
   launches join the `kernels` line as `launches_by_path` api_flat,
   api_graph and api_int8.
8. Placement, sharding and resilience, run after phase 7 and before
   phase 5, on the ciphertexts the script holds (nothing re-encrypted,
   the global HNSW not rebuilt): 8 logical placement devices on the one
   card (`launch.mesh.force_device_count`), every collection keyless
   with `PlacementSpec(kind="sharded", n_shards=4, n_replicas=2)`:
   (a) phase 3's 1M rows, flat: ids equal to phase 3's in 100% of slots,
       K1 once per shard and K2 once a batch, against the plain run as
       phase 3 (QPS and p50/p99 beside phase 3's); the same at 8 shards;
   (b) failover on (a): one replica of group 1 down (ids equal, not
       degraded), the whole group down (degraded, one group down, no id
       of its rows, kernel ids = plain ids, K1 three times a batch), both
       revived (ids equal to (a)'s); no kernel build after warmup;
   (c) the 1M rows, int8: ids equal to phase 4's in 100% (K4 is exact);
   (d) phase 1's graph corpus, ivf and flat pq8 (K5 per shard): ids
       equal to a single-device collection's in 100%;
   (e) the graph corpus as a sharded graph collection through the
       service, its subgraphs (M 8, ef_construction 48, seed + s) built
       by phase 1's workers: ids bit-equal to the plain torch walk's, K6
       once per shard; recall@10 beside phase 5's global graph;
   (f) (e) saved to a `.ppcol` and loaded (ids equal, no kernel build);
       a sharded flat collection over the graph corpus with a WAL and an
       `AsyncCheckpointer`: a checkpoint, 1,000 inserts, 100 deletes, an
       insert that crashes before its fsync, `recover`: the acknowledged
       state_digest and the ids answered before the crash;
   (g) `build_secure_scan_step` over the 1M rows in 4 shards: candidate
       and id sets equal to the global step's in every query.
   One `sharded_path` line per step and one `resilience` line; the
   launches join the `kernels` line as `launches_by_path` sharded_flat,
   sharded_int8, sharded_pq8, sharded_graph and secure_scan.
9. The LM server and its encrypted kNN-LM retrieval (`repro_torch.
   models`, `serving.engine.LMServer`, `launch.serve`), run after phase 8
   and before phase 4's pq8 engine, its tensors freed before that:
   (a) qwen3-1.7b at full width and depth (28 layers, d_model 2048,
       vocab 151,936; 1.72 B parameters drawn from a seeded generator on
       the card): in fp32, decode_step(prefill(prompt)) against
       forward(prompt + token) within the reference test's rtol = atol =
       2e-2 at B 4 / prompt 32, and at B 1 / prompt 4,080 in a 4,096-row
       cache (the prefill takes attention's chunked branch); in bf16,
       `LMServer.generate` at the reference CLI's B 4, prompt 32, 16 new
       tokens (prefill ms, decode ms a step against its weight-bytes
       bound, a profile of the decode step, greedy tokens against the
       fp32 model's), its first token equal to bf16 forward's argmax
       wherever the top-2 margin is resolved;
   (b) the kNN-LM loop of examples/rag_serving.py at full width: 100,000
       standard-normal rows of d 2048 (D 4112) with random next tokens,
       encrypted on the card by a `DataOwnerClient` and inserted into a
       keyless `SecureAnnService` flat collection; 8 bf16 decode steps at
       B 4, k 8, lambda 0.3, each step's probes one batch request; ids
       equal to the same steps under the plain versions in >= 99.9% of
       slots, blended tokens equal where the ids are, K1 and K2 once a
       step (none in the plain run), recall@8 against plaintext exact
       kNN of the probes;
   (d) `repro_torch.launch.serve.main(["--secure-ann"])` on the card at
       the reference CLI's defaults: (4, 16) tokens, its recall logged;
   (e) the other families, each model's tensors freed before the next
       and `torch.cuda.mem_get_info()` logged before each: mamba2-370m
       (48 layers), zamba2-1.2b (38) and whisper-small (12 + 12) at full
       width and depth, grok-1-314b (1 of 64 layers) and kimi-k2-1t-a32b
       (1 of 61) at full width.  In fp32, (a)'s check at B 4 / prompt 32
       (grok at capacity factor 8.0, as tests/test_arch_smoke.py; kimi at
       its smoke width: a full-width fp32 layer, 77.5 GB, does not fit);
       for mamba2 and zamba2 also at B 1 in two parts (a prompt above the
       SSD chunk of 128 must be a multiple of it, so S and S - 1 cannot
       both be): a 4,096-token prefill against forward's last position,
       then 128 decode steps against forward over all 4,224 tokens,
       position by position, within 2e-2 (zamba2 in a 4,608-row cache,
       so the shared block's prefill takes attention's chunked branch).
       In bf16, (a)'s `generate`, its bound from the bytes a decode step
       moves (the weights the decoder reads, every expert's included, as
       the MoE block reads them all; the KV rows, the cross K/V, the f32
       SSM state read and written); for grok and kimi n_active_params
       beside n_params and the active-weight bound beside it.  Then
       `serve.main(["--arch", a, "--secure-ann"])` for each of the five:
       (4, 16) tokens and its recall.
   Phase 2 holds K1 and K2 at (b)'s shapes (nq 4, n 100,000, d 2048,
   k' 64; B 4, n 64, D 4112).  One `lm` line per check; the launches
   join the `kernels` line as `launches_by_path` knn_lm and lm_serve
   (the serve runs of (d) and (e)).

10. Training on the card (after phase 9, before the pq8 engine; torch
   ops and autograd, none of the six kernels: the `train` path counts 0
   launches of each, read after counts set to 0 before the phase):
   (a) qwen3-1.7b in fp32 at full width and depth: loss and gradients
       with remat on against off at B 2 x S 256 (within 1e-5 x max|g| a
       leaf; bit-equal is expected: the same kernels on the same
       inputs), and one adamw step with 4 microbatches against 1 at B 4
       x S 256 (loss within rel 1e-4, weights within 5e-3: the bars of
       tests/test_training.py);
   (b) every arch at smoke width, loss and gradients on the card against
       the host (rel 1e-5; 1e-4 x max|g| + 1e-6 a leaf: the bars the CPU
       tests hold the port to against jax.grad);
   (c) qwen3-1.7b in bf16 at full width and depth, adamw with fp32
       moments, B 8 x S 512, 20 steps on `TokenStream(markov_temp=0.3)`:
       finite losses whose last five average below the first five; step
       ms (p50), tokens/s, peak allocated bytes, one profiled step's
       device busy time, its forward+backward and update device ms, and
       the bound: model FLOPs (6 N T, the attention's S x S products,
       remat's second forward) over the H100 SXM's dense bf16 peak;
   (d) (c)'s state at step 10 saved, restored into a fresh state and
       stepped: loss and weights bit-equal to the uninterrupted step 11;
       `launch.train --scale smoke --steps 40 --inject-failure-at 20` on
       the card finishes with restarts=1 and a lower loss;
   (e) the int8 ring all-reduce over 4 logical devices of the card,
       bit-equal to the same call over 4 logical host devices.
   One `train` line per check.

11. The dry run held against the card (`launch/{dryrun,roofline}.py`),
   last, after phase 5, on an emptied card: the card's total_memory must
   be `roofline.H100_MEMORY_BYTES`; phase 1's background run must have
   an ok record for every cell of `all_cells()` on 1pod_256, 2pod_512
   and 1card_h100 (one `dryrun` cell line each: one-card argument and
   peak bytes, fits_one_card, the roofline terms at chips 1 and 256);
   (a) phase 10's bf16 step (B 8 x S 512, adamw with fp32 moments, one
       microbatch) and phase 9's bf16 decode step (B 4, T_max 48),
       dry-run on 1card_h100 as ShapeConfigs of those sizes: argument
       bytes equal to the bytes of the tensors the phase allocated (the
       state or weights, the cache, the batch), the peak within 15% of
       the phase's measured one (those bytes + the max_memory_allocated
       increment over one step); FLOPs and the roofline bound beside the
       measured step;
   (b) the paper's cell on one card: the first PPANNS_CELLS entry whose
       1card_h100 record fits (scan_16m: 16,777,216 rows, d 128, B 1024,
       k 10, k' 128; 81.6 GB of ciphertext-shaped random fp32 data drawn
       in place): the sharded step over 4 logical shards against the
       global step, ids equal in 100% of slots, K1 4 + 1 and K2 1 + 1
       launches; device ms (median of 5) beside the roofline row; K1 (all
       rows and one shard) and K2 at its shapes against their plain
       versions, with the library over row chunks summed (a (1024, 2^24)
       matrix does not fit beside the ciphertexts).  Their launches join
       the `kernels` line as `launches_by_path` scan_16m;
   (c) after (b) has freed its 81.6 GB, the reference's bf16 cells at
       their sizes, nothing cut: scan_16m_bf16 (B 1024) and
       scan_16m_bf16_b4096 (B 4096) over one corpus of 2^24 rows drawn
       in place in bf16 (40.8 GB; bf16 queries and trapdoors a cell),
       K1 and K2 reading it in place: sharded ids = global ids in 100%
       of slots, K1 4 + 1 and K2 1 + 1 launches, device ms (median of 5;
       3 at B 4096) beside the roofline row, argument bytes equal to the
       dry run's and the peak within 1% of its peak (a float32 copy of
       C_sap alone would add 8.6 GB); at B 1024 also K1 at one shard and
       on all rows against its plain version (plain and library timed
       at each), K1 on all rows bit-equal to the float32 kernel on a
       float32 copy of C_sap, and K2 on the global
       step's candidates bit-equal to the float32 kernel on their
       float32 copy.

The second-to-last line is the kernels' JSON record, the last line the
device record.  Without a CUDA device the script exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet), one home for the port: fp32 outside
# the tensor cores, dense bf16 and int8 on the tensor cores, HBM3.
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES_PER_S, PEAK_BF16_FLOPS, PEAK_FP32_FLOPS,
    PEAK_INT8_OPS)

K = 10
RATIO_K = 8
BATCH = 32
L2_RTOL = 1e-5
Z_RTOL = 1e-5
MIN_ID_AGREEMENT = 0.999
MAX_RECALL_GAP = 0.005
HALF_DTYPES = ("bfloat16", "float16")   # the 16-bit rows the kernels read
NO_PATH = "-"           # a record's home when no path runs its shape
# the path whose launches a 16-bit kernel record reports (phase 3's
# all-bf16 scan form; no path reads f16 ciphertexts)
SCAN_HOME = {"bfloat16": "scan_1m_bf16", "float16": NO_PATH}
GRAPH_RTOL = 1e-5
OWNER_SEED = 0
# graph path: the owner's HNSW build settings (those of BENCH_graph.json)
GRAPH_M = 8
GRAPH_EF_CONSTRUCTION = 48
EF_SEARCH = 96
ORACLE_QUERIES = 64
# IVF paths: the reference backend's defaults
PQ_M, PQ_SEED = 16, 0           # ADCFilter's defaults: phase 4's pq8 book
IVF_PARTITIONS = 64
IVF_NPROBE = 8


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, in ms.  Before each timed call the
    stream is held busy by a spin kernel, so the host has enqueued the
    start event, the call and the end event before the card reaches
    them: the interval is the call's device time, without the host's
    launch gaps."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)          # ~1 ms of spinning
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 10) -> float:
    """Median host-clock time of a call ended by a synchronize, in ms."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


@contextlib.contextmanager
def plain_kernels():
    """Test-only switch: route the main paths' kernel entry points to
    their plain PyTorch versions, for the comparison runs.  The port
    itself has no such switch."""
    from repro_torch.kernels.adc_topk import adc_topk, ops as adc_ops
    from repro_torch.kernels.dce_comp import dce_comp, ops as dce_ops
    from repro_torch.kernels.graph_expand import graph_expand
    from repro_torch.kernels.graph_expand import ops as graph_ops
    from repro_torch.kernels.l2_topk import l2_topk, ops as l2_ops
    routes = [(l2_ops, "knn", l2_topk.plain_knn),
              (dce_ops, "refine_topk", dce_comp.plain_refine_topk),
              (graph_ops, "graph_walk", graph_expand.plain_graph_walk),
              (adc_ops, "sq_adc_topk", adc_topk.plain_sq_adc_topk),
              (adc_ops, "pq_adc_topk", adc_topk.plain_pq_adc_topk),
              (adc_ops, "sq_encode_queries",
               adc_topk.plain_sq_encode_queries)]
    saved = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), kern in zip(routes, saved):
            setattr(mod, name, kern)


def _launch_counters() -> dict:
    from repro_torch.kernels.adc_topk import adc_topk
    from repro_torch.kernels.dce_comp import dce_comp
    from repro_torch.kernels.graph_expand import graph_expand
    from repro_torch.kernels.l2_topk import l2_topk
    return {"l2_topk": l2_topk.launches, "dce_comp": dce_comp.launches,
            "graph_expand": graph_expand.launches,
            "adc_topk": adc_topk.launches}


def kernel_launches() -> dict:
    """Launch counts by kernel, "module.entry": each wrapper counts the
    launches of its kernel (z_matrix under batched_z_matrix; a pass of a
    top-k above 1024 is a launch)."""
    return {f"{mod}.{k}": v for mod, counts in _launch_counters().items()
            for k, v in counts.items()}


def reset_launches() -> None:
    for counts in _launch_counters().values():
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def untallied():
    """Launches inside the block (timing a kernel alone) leave the
    counts as they were."""
    saved = {mod: dict(c) for mod, c in _launch_counters().items()}
    try:
        yield
    finally:
        for mod, counts in _launch_counters().items():
            counts.update(saved[mod])


# --------------------------------------------------------------- phase 2

def check_l2(nq: int, n: int, d: int, gen, dtype: str = "float32") -> dict:
    """The tile entry against its plain version.  16-bit `dtype`: rows
    and queries rounded to it and read in place, the output also
    bit-equal to the entry's on float32 copies of the same values, on no
    path (NO_PATH), and the library call upcasts the rows in the call."""
    import torch
    from repro_torch.kernels.l2_topk import l2_topk
    dev = torch.device("cuda")
    t = getattr(torch, dtype)
    # DCPE-like magnitudes: s = 1024 times unit-scale coordinates
    Q = (1024.0 * torch.randn((nq, d), generator=gen, device=dev)).to(t)
    X = (1024.0 * torch.randn((n, d), generator=gen, device=dev)).to(t)
    Q32, X32 = Q.float(), X.float()
    got = l2_topk.pairwise_sq_dists(Q, X)
    want = l2_topk.plain_pairwise_sq_dists(Q, X)
    torch.cuda.synchronize()
    scale = (Q32 * Q32).sum(1)[:, None] + (X32 * X32).sum(1)[None, :]
    err = (got - want).abs()
    rel = float((err / scale).max())
    if not torch.isfinite(got).all() or rel > L2_RTOL:
        raise AssertionError(f"l2 kernel disagrees at nq={nq} n={n} "
                             f"d={d} {dtype}: max rel err {rel:.3g}")
    half = {}
    if dtype != "float32":
        half = {"row_dtype": dtype, "home": NO_PATH,
                "bit_equal_to_float32_kernel": bool(torch.equal(
                    got, l2_topk.pairwise_sq_dists(Q32, X32))),
                "ms_float32_copy": device_ms(
                    lambda: l2_topk.pairwise_sq_dists(Q32, X32))}
        if not half["bit_equal_to_float32_kernel"]:
            raise AssertionError(f"l2 tiles on {dtype} rows differ from "
                                 f"their float32 copy at nq={nq} n={n}")
    base = scale.clone()
    flops = 2.0 * nq * n * d + 2.0 * (nq + n) * d + 3.0 * nq * n
    nbytes = Q.element_size() * nq * d + X.element_size() * n * d \
        + 4.0 * nq * n
    b_ms, b_by = bound(flops, nbytes)
    return {
        "name": f"l2_topk.pairwise_sq_dists[nq={nq},n={n},d={d}"
                + ("" if dtype == "float32" else f",{dtype}") + "]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk/l2_topk.py:77",
        "max_abs_err": float(err.max()), "max_rel_err": rel, **half,
        "ms": device_ms(lambda: l2_topk.pairwise_sq_dists(Q, X)),
        "plain_ms": device_ms(lambda: l2_topk.plain_pairwise_sq_dists(Q, X)),
        "library_ms": device_ms(
            lambda: torch.addmm(base, Q.float(), X.float().T, beta=1.0,
                                alpha=-2.0)),
        "library_call": "torch.addmm(qn+xn, Q, X.T, alpha=-2)" + (
            "" if dtype == "float32" else
            f" on the {dtype} rows and queries upcast in the call"),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def knn_against_plain(Q, X, k: int, exact: bool = False) -> dict:
    """The fused scan against its plain version (the chunked merge over
    plain tiles) on the same rows: ids equal in >= MIN_ID_AGREEMENT of
    slots and distances within L2_RTOL * (||q||^2 + ||x||^2) where they
    agree (`exact`: in every slot, and equal).  Raises otherwise.  ->
    the record's error fields and its bound (Q and X counted in their own
    element sizes: 16-bit rows move half the bytes)."""
    import torch
    from repro_torch.kernels.l2_topk import l2_topk
    nq, d = Q.shape
    n = X.shape[0]
    got = l2_topk.knn(Q, X, k)
    want = l2_topk.plain_knn(Q, X, k)
    torch.cuda.synchronize()
    kk = min(k, n)
    same = got[1] == want[1]
    agree = float(same.float().mean())
    rows = X[want[1].clamp(min=0)].float()    # no (n, d) temporary
    Qf = Q.float()
    scale = (Qf * Qf).sum(1)[:, None] + (rows * rows).sum(-1)
    err = (got[0] - want[0]).abs()[same]
    rel = float((err / scale[same]).max()) if err.numel() else 0.0
    if (got[1].shape != (nq, kk) or not torch.isfinite(got[0]).all()
            or agree < (1.0 if exact else MIN_ID_AGREEMENT)
            or rel > (0.0 if exact else L2_RTOL)):
        raise AssertionError(f"fused l2 scan disagrees at nq={nq} n={n} "
                             f"d={d} k={k}: ids {agree}, max rel err {rel}")
    flops = 2.0 * nq * n * d + 2.0 * (nq + n) * d + 3.0 * nq * n
    nbytes = (Q.element_size() * nq * d + X.element_size() * n * d
              + 12.0 * nq * kk)
    b_ms, b_by = bound(flops, nbytes)
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "max_rel_err": rel, "id_agreement": agree,
            "bound_ms": b_ms, "bound_by": b_by}


def check_knn(nq: int, n: int, d: int, k: int, gen,
              home: str | None = None, exact: bool = False) -> dict:
    """The fused scan against its plain version (`knn_against_plain`):
    DCPE-like magnitudes, the last 1% of rows repeating the first, so
    exact ties between distinct ids occur.  `exact`: integer rows and
    queries in [-8, 8] instead (every distance exact in any summation
    order), and the ids and distances must be equal (the k' 1600 record:
    at 1600 slots, fp32 sums in another order swap some neighbours
    within 1e-6 of each other)."""
    import torch
    from repro_torch.kernels.l2_topk import l2_topk
    dev = torch.device("cuda")
    if exact:
        Q = torch.randint(-8, 9, (nq, d), generator=gen, device=dev).float()
        X = torch.randint(-8, 9, (n, d), generator=gen, device=dev).float()
    else:
        Q = 1024.0 * torch.randn((nq, d), generator=gen, device=dev)
        X = 1024.0 * torch.randn((n, d), generator=gen, device=dev)
    dup = n // 100
    if dup:
        X[n - dup:] = X[:dup]
    checked = knn_against_plain(Q, X, k, exact)
    kk = min(k, n)
    base = (Q * Q).sum(1)[:, None] + (X * X).sum(1)[None, :]
    Xt = X.T
    return {
        "name": f"l2_topk.knn[nq={nq},n={n},d={d},k={k}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk/l2_topk.py:77",
        **checked, "duplicated_rows": dup, "integer_rows": exact,
        "ms": device_ms(lambda: l2_topk.knn(Q, X, k)),
        "plain_ms": device_ms(lambda: l2_topk.plain_knn(Q, X, k),
                              reps=10, warmup=2),
        "library_ms": device_ms(lambda: torch.topk(
            torch.addmm(base, Q, Xt, beta=1.0, alpha=-2.0), kk, dim=1,
            largest=False)),
        "library_call": "torch.addmm(qn+xn, Q, X.T, alpha=-2), "
                        "torch.topk(largest=False)",
        **({"home": home} if home else {}),
    }


def dce_inputs(B: int, n: int, d: int, gen):
    """Real DCE ciphertexts of B candidate sets and trapdoors of B
    queries, each set drawn around its query so near-ties occur."""
    import torch
    from repro_torch.core import dce
    rng = np.random.default_rng(d)
    key = dce.keygen(d, seed=d)
    Qp = rng.standard_normal((B, d)).astype(np.float32)
    P = Qp[:, None, :] + 0.5 * rng.standard_normal((B, n, d)).astype(
        np.float32)
    C = dce.encrypt_torch(P.reshape(B * n, d), key, gen, "cuda")
    T = dce.trapgen(Qp, key, seed=d + 1)
    return (C.reshape(B, n, 4, -1).contiguous(),
            torch.as_tensor(T, device="cuda").contiguous())


def check_z(B: int, n: int, d: int, gen, single: bool = False,
            dtype: str = "float32") -> dict:
    """The Z entries against their plain versions.  16-bit `dtype`:
    ciphertexts and trapdoors rounded to it and read in place, Z also
    bit-equal to the entry's on float32 copies of the same values, on no
    path (NO_PATH), and the library call upcasts and scales in the
    call."""
    import torch
    from repro_torch.kernels.dce_comp import dce_comp
    t = getattr(torch, dtype)
    C, T = dce_inputs(B, n, d, gen)
    C, T = C.to(t), T.to(t)
    D = C.shape[-1]
    if single:
        C, T = C[0].contiguous(), T[0].contiguous()
        kern, plain = dce_comp.z_matrix, dce_comp.plain_z_matrix
    else:
        kern, plain = dce_comp.batched_z_matrix, dce_comp.plain_batched_z_matrix
    got = kern(C, T)
    want = plain(C, T)
    torch.cuda.synchronize()
    zmax = float(want.abs().max())
    err = (got - want).abs()
    sure = want.abs() > Z_RTOL * zmax
    signs_ok = bool(((got < 0) == (want < 0))[sure].all())
    if not torch.isfinite(got).all() or float(err.max()) > Z_RTOL * zmax \
            or not signs_ok:
        raise AssertionError(f"Z kernel disagrees at B={B} n={n} D={D} "
                             f"{dtype}: max err {float(err.max()):.3g} of "
                             f"max|Z| {zmax:.3g}, signs ok {signs_ok}")
    exact = {}
    if single:
        # K3's split plan against the batched entry's plan (32 copies of
        # the set, unsplit): the same two fp32 chains, so bit-equal; and
        # on small integers (every sum exact) bit-equal to the plain one
        Cb32 = C[None].expand(32, -1, -1, -1).contiguous()
        Tb32 = T[None].expand(32, -1).contiguous()
        exact["equal_to_batched_entry"] = bool(torch.equal(
            got, dce_comp.batched_z_matrix(Cb32, Tb32)[5]))
        Ci = torch.randint(-8, 9, C.shape, generator=gen,
                           device="cuda").to(t)
        Ti = torch.randint(-3, 4, T.shape, generator=gen,
                           device="cuda").to(t)
        exact["equal_to_plain_on_integers"] = bool(torch.equal(
            kern(Ci, Ti), plain(Ci, Ti)))
        exact["plan"] = dce_comp.z_plan(1, n)
    C32, T32 = C.float(), T.float()
    if dtype != "float32":
        exact.update(row_dtype=dtype, home=NO_PATH,
                     bit_equal_to_float32_kernel=bool(torch.equal(
                         got, kern(C32, T32))),
                     ms_float32_copy=device_ms(lambda: kern(C32, T32)))
    if not all(v for k, v in exact.items()
               if k not in ("plan", "row_dtype", "home", "ms_float32_copy")):
        raise AssertionError(f"Z at B={B} n={n} D={D} {dtype} is not "
                             f"bit-equal: {exact}")
    Cb = C if not single else C[None]
    Tb = T if not single else T[None]
    nb = Cb.shape[0]

    if dtype == "float32":
        L1 = (Cb[:, :, 0] * Tb[:, None]).contiguous()
        L2 = (Cb[:, :, 1] * Tb[:, None]).contiguous()
        R3 = Cb[:, :, 2].transpose(1, 2)
        R4 = Cb[:, :, 3].transpose(1, 2)

        def library():
            return torch.baddbmm(torch.bmm(L1, R3), L2, R4, beta=1.0,
                                 alpha=-1.0)
    else:
        def library():
            Cf, Tf = Cb.float(), Tb.float()[:, None]
            return torch.baddbmm(
                torch.bmm(Cf[:, :, 0] * Tf, Cf[:, :, 2].transpose(1, 2)),
                Cf[:, :, 1] * Tf, Cf[:, :, 3].transpose(1, 2), beta=1.0,
                alpha=-1.0)
    flops = 4.0 * nb * n * n * D + 2.0 * nb * n * D + nb * n * n
    nbytes = (C.element_size() * (nb * n * 4 * D + nb * D)
              + 4.0 * nb * n * n)
    b_ms, b_by = bound(flops, nbytes)
    name = ("dce_comp.z_matrix" if single else "dce_comp.batched_z_matrix")
    shape = f"n={n},D={D}" if single else f"B={B},n={n},D={D}"
    return {
        "name": f"{name}[{shape}"
                + ("" if dtype == "float32" else f",{dtype}") + "]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/dce_comp.cu",
        "replaces": ("src/repro/kernels/dce_comp/dce_comp.py:67" if single
                     else "src/repro/kernels/dce_comp/dce_comp.py:131"),
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max()) / zmax, **exact,
        "ms": device_ms(lambda: kern(C, T)),
        "plain_ms": device_ms(lambda: plain(C, T)),
        "library_ms": device_ms(library),
        "library_call": "torch.baddbmm(torch.bmm(L1, R3), L2, R4, alpha=-1)"
                        + (" on pre-scaled L1, L2" if dtype == "float32" else
                           f"; the {dtype} rows upcast and scaled in the "
                           f"call"),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def refine_against_plain(C_dce, cand, T, valid, k: int) -> dict:
    """The fused refine against its plain version (gather, Z, wins,
    stable sort): its win counts must equal those of the Z entry (one
    main loop) exactly, and the plain version's wins and ids wherever
    every pair of valid slots has |Z_plain| > Z_RTOL * max|Z|; the rest
    is reported.  valid None: every slot.  Raises otherwise.  -> the
    record's check fields and its bound, and Z alone by `bmm` +
    `baddbmm` on the gathered, pre-scaled rows (the library call; for
    16-bit rows the upcast of the gathered rows and the scaling too)."""
    import torch
    from repro_torch.kernels.dce_comp import dce_comp
    from repro_torch.kernels.dce_comp.ref import batched_wins
    B, n = cand.shape
    D = C_dce.shape[-1]
    dev = C_dce.device
    args = (C_dce, cand, T, valid, k)
    ids, wins = dce_comp.refine_topk(*args, return_wins=True)
    ids_p, wins_p = dce_comp.plain_refine_topk(*args, return_wins=True)
    Cc = C_dce[cand]
    z_k = dce_comp.batched_z_matrix(Cc, T)
    from_z = torch.equal(wins, batched_wins(z_k, valid))
    z_p = dce_comp.plain_batched_z_matrix(Cc, T)
    torch.cuda.synchronize()
    ok = (torch.ones((B, n), dtype=torch.bool, device=dev) if valid is None
          else valid)
    pairs = ok[:, :, None] & ok[:, None, :] & ~torch.eye(
        n, dtype=torch.bool, device=dev)[None]
    zmax = float(z_p[pairs].abs().max())
    err = float((z_k - z_p).abs()[pairs].max())
    unsure = pairs & (z_p.abs() <= Z_RTOL * zmax)
    del z_k, z_p
    sure_row = ~unsure.any(-1) & ok
    sure_query = ~unsure.any(-1).any(-1)
    wins_ok = bool((wins == wins_p)[sure_row].all())
    ids_ok = bool((ids == ids_p)[sure_query].all())
    if not (from_z and wins_ok and ids_ok):
        raise AssertionError(f"fused refine disagrees at B={B} n={n} D={D}: "
                             f"wins = Z entry's {from_z}, = plain on sure "
                             f"rows {wins_ok}, ids on sure queries {ids_ok}")
    flops = 4.0 * B * n * n * D + 2.0 * B * n * D + B * n * n
    nbytes = (C_dce.element_size() * B * n * 4 * D + T.element_size() * B * D
              + 9.0 * B * n + 8.0 * B * k)
    b_ms, b_by = bound(flops, nbytes)
    if C_dce.dtype == torch.float32:
        L1 = (Cc[:, :, 0] * T[:, None]).contiguous()
        L2 = (Cc[:, :, 1] * T[:, None]).contiguous()
        R3 = Cc[:, :, 2].transpose(1, 2)
        R4 = Cc[:, :, 3].transpose(1, 2)

        def library():
            return torch.baddbmm(torch.bmm(L1, R3), L2, R4, beta=1.0,
                                 alpha=-1.0)
    else:
        Tf = T.float()

        def library():
            Cf = Cc.float()
            return torch.baddbmm(
                torch.bmm(Cf[:, :, 0] * Tf[:, None],
                          Cf[:, :, 2].transpose(1, 2)),
                Cf[:, :, 1] * Tf[:, None], Cf[:, :, 3].transpose(1, 2),
                beta=1.0, alpha=-1.0)
    return {"max_abs_err": err, "max_rel_err": err / zmax,
            "wins_equal_z_entry": from_z,
            "wins_agreement": float((wins == wins_p).float().mean()),
            "id_agreement": float((ids == ids_p).float().mean()),
            "unsure_rows": int((~sure_row & ok).sum()),
            "unsure_queries": int((~sure_query).sum()),
            "bound_ms": b_ms, "bound_by": b_by, "library": library}


def refine_record(C_dce, cand, T, valid, k: int, home: str,
                  reps: int = 30) -> dict:
    """`refine_against_plain`, then device ms of the kernel, its plain
    version and the library's Z alone."""
    from repro_torch.kernels.dce_comp import dce_comp
    checked = refine_against_plain(C_dce, cand, T, valid, k)
    library = checked.pop("library")
    B, n = cand.shape
    args = (C_dce, cand, T, valid, k)
    dt = str(C_dce.dtype).removeprefix("torch.")
    return {
        "name": f"dce_comp.refine_topk[B={B},n={n},D={C_dce.shape[-1]},"
                f"k={k}" + ("" if dt == "float32" else f",{dt}") + "]",
        "row_dtype": dt,
        "route": "cuda",
        "source": "src/repro_torch/csrc/dce_comp.cu",
        "replaces": "src/repro/kernels/dce_comp/dce_comp.py:131",
        "home": home, **checked,
        "ms": device_ms(lambda: dce_comp.refine_topk(*args), reps=reps),
        "plain_ms": device_ms(lambda: dce_comp.plain_refine_topk(*args),
                              reps=reps),
        "library_ms": device_ms(library, reps=reps),
        "library_call": "torch.baddbmm(torch.bmm(L1, R3), L2, R4, alpha=-1)"
                        " on gathered, pre-scaled L1, L2 (Z alone)" + (
                            "" if dt == "float32" else
                            f"; the {dt} rows upcast and scaled in the call"),
    }


def check_refine(B: int, n: int, d: int, k: int, gen, home: str) -> dict:
    """The fused refine against its plain version (`refine_record`) on
    real DCE ciphertexts read through a shuffled cand: ~10% of slots
    invalid (half of them with id -1, as the graph filter leaves them),
    query 0 with fewer valid slots than k."""
    import torch
    C, T = dce_inputs(B, n, d, gen)
    D = C.shape[-1]
    C_dce = C.reshape(B * n, 4, D)
    dev = C.device
    cand = (torch.arange(B, device=dev)[:, None] * n
            + torch.argsort(torch.rand((B, n), generator=gen, device=dev),
                            dim=1))
    valid = torch.rand((B, n), generator=gen, device=dev) > 0.1
    valid[0] = False
    valid[0, :k - 3] = True
    cand = torch.where(valid | (cand % 2 == 0), cand, -1).contiguous()
    return dict(refine_record(C_dce, cand, T, valid, k, home),
                invalid_slots=int((~valid).sum()))


def equal_outputs(got, want) -> bool:
    """Every output tensor equal, dtype and bits."""
    import torch
    return all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


def check_knn_16(nq: int, n: int, d: int, k: int, gen, dtype: str,
                 home: str) -> dict:
    """K1 reading 16-bit rows in place: DCPE-like rows and queries (1%
    of rows duplicated) rounded to `dtype`; ids against the plain version
    (`knn_against_plain`'s tolerances), and ids and distances bit-equal
    to the float32 kernel on float32 copies of the same values.  The
    library yardstick upcasts the rows in the call."""
    import torch
    from repro_torch.kernels.l2_topk import l2_topk
    dev = torch.device("cuda")
    t = getattr(torch, dtype)
    Q = (1024.0 * torch.randn((nq, d), generator=gen, device=dev)).to(t)
    X = (1024.0 * torch.randn((n, d), generator=gen, device=dev)).to(t)
    dup = n // 100
    X[n - dup:] = X[:dup]
    checked = knn_against_plain(Q, X, k)
    Q32, X32 = Q.float(), X.float()
    bit_equal = equal_outputs(l2_topk.knn(Q, X, k), l2_topk.knn(Q32, X32, k))
    if not bit_equal:
        raise AssertionError(f"K1 on {dtype} rows differs from K1 on their "
                             f"float32 copy at nq={nq} n={n} d={d} k={k}")
    ms32 = device_ms(lambda: l2_topk.knn(Q32, X32, k))
    base = (Q32 * Q32).sum(1)[:, None] + (X32 * X32).sum(1)[None, :]
    del X32
    kk = min(k, n)
    return {
        "name": f"l2_topk.knn[nq={nq},n={n},d={d},k={k},{dtype}]",
        "row_dtype": dtype, "route": "cuda",
        "source": "src/repro_torch/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk/l2_topk.py:77", **checked,
        "bit_equal_to_float32_kernel": bit_equal, "duplicated_rows": dup,
        "ms": device_ms(lambda: l2_topk.knn(Q, X, k)),
        "ms_float32_copy": ms32,
        "plain_ms": device_ms(lambda: l2_topk.plain_knn(Q, X, k),
                              reps=10, warmup=2),
        "library_ms": device_ms(lambda: torch.topk(
            torch.addmm(base, Q32, X.float().T, beta=1.0, alpha=-2.0), kk,
            dim=1, largest=False)),
        "library_call": f"X.float() (the {dtype} rows upcast), "
                        f"torch.addmm(qn+xn, Q, X.T, alpha=-2), "
                        f"torch.topk(largest=False)",
        "home": home}


def check_refine_16(B: int, n: int, d: int, k: int, gen, dtype: str,
                    home: str) -> dict:
    """K2 reading 16-bit ciphertexts in place: `check_refine`'s inputs
    with C_dce and T rounded to `dtype`; wins and ids against the plain
    version (`refine_against_plain`'s rules), and wins and ids bit-equal
    to the float32 kernel on float32 copies of the same values."""
    import torch
    from repro_torch.kernels.dce_comp import dce_comp
    t = getattr(torch, dtype)
    C, T = dce_inputs(B, n, d, gen)
    D = C.shape[-1]
    C_dce = C.reshape(B * n, 4, D).to(t)
    T = T.to(t)
    dev = C.device
    cand = (torch.arange(B, device=dev)[:, None] * n
            + torch.argsort(torch.rand((B, n), generator=gen, device=dev),
                            dim=1))
    valid = torch.rand((B, n), generator=gen, device=dev) > 0.1
    cand = torch.where(valid | (cand % 2 == 0), cand, -1).contiguous()
    bit_equal = equal_outputs(
        dce_comp.refine_topk(C_dce, cand, T, valid, k, return_wins=True),
        dce_comp.refine_topk(C_dce.float(), cand, T.float(), valid, k,
                             return_wins=True))
    if not bit_equal:
        raise AssertionError(f"K2 on {dtype} rows differs from K2 on their "
                             f"float32 copy at B={B} n={n} D={D}")
    C32, T32 = C_dce.float(), T.float()
    rec = refine_record(C_dce, cand, T, valid, k, home)
    return dict(rec, bit_equal_to_float32_kernel=bit_equal,
                ms_float32_copy=device_ms(
                    lambda: dce_comp.refine_topk(C32, cand, T32, valid, k)),
                invalid_slots=int((~valid).sum()))


def graph_inputs(R: int, M0: int, d: int, nq: int, gen):
    """A synthetic layer-0 graph: random ids with ~10% -1 slots, ~2% of
    rows with ok = 0, integer-valued rows and queries in [-8, 8] (every
    fp32 distance exact in any summation order), random entry points,
    and query 0 with entry -1 (an empty graph's query)."""
    import torch
    dev = torch.device("cuda")
    C = torch.randint(-8, 9, (R, d), generator=gen, device=dev).float()
    Q = torch.randint(-8, 9, (nq, d), generator=gen, device=dev).float()
    neigh0 = torch.randint(0, R, (R, M0), generator=gen, device=dev,
                           dtype=torch.int32)
    neigh0[torch.rand((R, M0), generator=gen, device=dev) < 0.1] = -1
    ok = torch.rand(R, generator=gen, device=dev) > 0.02
    ep = torch.randint(0, R, (nq,), generator=gen, device=dev)
    ep[0] = -1
    ep_d = ((C[ep.clamp(min=0)] - Q) ** 2).sum(-1)
    ep_d = torch.where(ep >= 0, ep_d, float("inf"))
    return neigh0, ok, C, Q, ep, ep_d


def graph_expand_bound(hops, edges, R: int, M0: int, d: int, ef_cap: int,
                       up_hops=None, up_edges=None, M: int = 0,
                       esize: int = 4) -> tuple[float, str]:
    """K6's bound from what this run's walks needed: per layer-0 hop the
    M0 ids of the expanded row; per scored edge (a fresh neighbour:
    valid, ok, not yet visited) its row of d floats and its ok flag, and
    3d fp32 operations (sub, mul, add); once per query its query row and
    entry point; and the outputs (beam ids and distances, hops, edges and
    the visited words).  Padding slots, rows with ok = 0 and neighbours
    already visited need no row.  With the upper layers' steps (up_hops,
    up_edges: valid neighbours scored), M ids a step and the same per
    edge.  `esize`: bytes of a row element (2 for 16-bit rows)."""
    nq = hops.shape[0]
    n_hops, n_edges = int(hops.sum()), int(edges.sum())
    u_hops = int(up_hops.sum()) if up_hops is not None else 0
    u_edges = int(up_edges.sum()) if up_edges is not None else 0
    nbytes = (n_hops * M0 * 4.0 + u_hops * M * 4.0
              + (n_edges + u_edges) * (esize * d + 1.0)
              + nq * (esize * d + 8.0)
              + nq * (ef_cap * 8.0 + 8.0 + ((R + 31) // 32) * 4.0))
    return bound((n_edges + u_edges) * 3.0 * d, nbytes)


def check_graph_expand(R: int, M0: int, d: int, gen, nq: int = BATCH,
                       ef: int = 96, ef_cap: int = 128,
                       max_hops: int = 512) -> dict:
    """K6's layer-0 entry against its plain version (integer-valued
    rows: bit-equal ids, distances, visited, hops and edges); the defaults
    are the graph path's beam plan (k' 80, ef_search 96: ef 96, ef_cap
    128, max_hops 512)."""
    import torch
    from repro_torch.kernels.graph_expand import graph_expand
    args = graph_inputs(R, M0, d, nq, gen)
    kw = dict(ef=ef, ef_cap=ef_cap, max_hops=max_hops)
    got = graph_expand.expand_layer0(*args, **kw)
    want = graph_expand.plain_expand_layer0(*args, **kw)
    torch.cuda.synchronize()
    same = got[0] == want[0]
    agree = float(same.float().mean())
    fin = same & torch.isfinite(want[1])
    err = (got[1] - want[1]).abs()[fin]
    rel = err / want[1].abs()[fin].clamp_min(1e-30)
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float(rel.max()) if rel.numel() else 0.0
    names = ("ids", "distances", "visited", "hops", "edges")
    bad = [nm for nm, g, w in zip(names, got, want)
           if g.dtype != w.dtype or not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"graph_expand differs from its plain version "
                             f"at R={R} M0={M0} d={d}: {bad} (ids equal in "
                             f"{agree} of slots, max rel err {max_rel})")
    hops, edges = got[3], got[4]
    b_ms, b_by = graph_expand_bound(hops, edges, R, M0, d, ef_cap)
    ms = device_ms(lambda: graph_expand.expand_layer0(*args, **kw))
    return {
        "name": f"graph_expand.expand_layer0[nq={nq},R={R},M0={M0},d={d}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/graph_expand.cu",
        "replaces": "src/repro/kernels/graph_expand/graph_expand.py:234",
        "max_abs_err": max_abs, "max_rel_err": max_rel,
        "beam_slot_id_agreement": agree, "bit_equal": True,
        "max_hops_per_query": int(hops.max()),
        "mean_hops_per_query": float(hops.float().mean()),
        "mean_edges_per_query": float(edges.float().mean()),
        "ms": ms, "us_per_hop": 1e3 * ms / max(1, int(hops.max())),
        "plain_ms": device_ms(
            lambda: graph_expand.plain_expand_layer0(*args, **kw),
            reps=10, warmup=2),
        "library_ms": None, "library_call": "none (no PyTorch call runs "
                                            "a beam search)",
        "bound_ms": b_ms, "bound_by": b_by,
    }


def walk_inputs(R: int, M0: int, M: int, LU: int, d: int, nq: int, gen,
                empty_top: int = 3):
    """`graph_inputs`' layer 0 under LU upper layers: the top `empty_top`
    padded with -1 rows only, the others M random ids (~10% -1) on nested
    node sets of R / 4^(li+1) rows, all holding the entry (an ok row)."""
    import torch
    dev = torch.device("cuda")
    neigh0, ok, C, Q, _, _ = graph_inputs(R, M0, d, nq, gen)
    perm = torch.randperm(R, generator=gen, device=dev)
    up = torch.full((LU, R, M), -1, dtype=torch.int32, device=dev)
    for li in range(LU - empty_top):
        nodes = perm[: max(2, R >> (2 * li + 2))]
        pick = torch.randint(0, nodes.numel(), (nodes.numel(), M),
                             generator=gen, device=dev)
        rows = nodes[pick].int()
        rows[torch.rand(rows.shape, generator=gen, device=dev) < 0.1] = -1
        up[li, nodes] = rows
    entry = int(perm[0])
    ok[entry] = True
    return neigh0, up.contiguous(), ok, C, Q, entry


def check_graph_walk(R: int, M0: int, M: int, LU: int, d: int, gen,
                     nq: int = BATCH, ef: int = 96, ef_cap: int = 128,
                     max_hops: int = 512, home: str | None = None) -> dict:
    """The fused walk against its plain version (the torch walk) on a
    synthetic graph with upper layers (3 of them empty) over
    integer-valued rows: every distance is exact in any summation order,
    so ids, distances, visited words, hops and edges must be bit-equal.
    The defaults are the graph path's beam plan."""
    import torch
    from repro_torch.graph import traverse
    from repro_torch.kernels.graph_expand import graph_expand
    n0, up, ok, C, Q, entry = walk_inputs(R, M0, M, LU, d, nq, gen)
    kw = dict(ef_cap=ef_cap, max_hops=max_hops)
    args = (n0, up, ok, C, Q, entry, ef)
    got = graph_expand.graph_walk(*args, **kw)
    want = graph_expand.plain_graph_walk(*args, **kw)
    torch.cuda.synchronize()
    names = ("ids", "distances", "visited", "hops", "edges")
    bad = [nm for nm, g, w in zip(names, got, want)
           if g.dtype != w.dtype or not torch.equal(g, w)]
    G, pool, svis = graph_expand.walk_plan(R, M0, M, d, ef)
    smem = graph_expand.walk_smem(ef, M0, M, d, G, pool, svis, R)
    if graph_expand.walk_smem_on_card(ef, M0, M, d, G, pool, svis, R) != smem:
        bad.append("shared-memory plan")
    if bad:
        raise AssertionError(f"graph_walk differs from the torch walk at "
                             f"R={R} M0={M0} M={M} d={d} ef={ef}: {bad}")
    hops, edges = got[3], got[4]
    _, _, up_hops, up_edges = traverse.upper_entry(up, ok, (C,), Q, entry)
    b_ms, b_by = graph_expand_bound(hops - up_hops, edges - up_edges, R,
                                    M0, d, ef_cap, up_hops, up_edges, M)
    ms = device_ms(lambda: graph_expand.graph_walk(*args, **kw))
    return {
        "name": f"graph_expand.graph_walk[nq={nq},R={R},M0={M0},M={M},"
                f"LU={LU},d={d},ef={ef},ef_cap={ef_cap}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/graph_expand.cu",
        "replaces": "src/repro/kernels/graph_expand/graph_expand.py:234",
        "also_replaces": "src/repro/graph/traverse.py:141",
        "max_abs_err": 0.0, "bit_equal": True,
        "plan": {"rows_a_group": G, "adjacency_pool": pool,
                 "visited_on_chip": svis, "shared_bytes": smem},
        "max_hops_per_query": int(hops.max()),
        "mean_hops_per_query": float(hops.float().mean()),
        "mean_upper_hops_per_query": float(up_hops.float().mean()),
        "mean_edges_per_query": float(edges.float().mean()),
        "ms": ms, "us_per_hop": 1e3 * ms / int(hops.max()),
        "plain_ms": device_ms(lambda: graph_expand.plain_graph_walk(
            *args, **kw), reps=5, warmup=1),
        "library_ms": None, "library_call": "none (no PyTorch call runs "
                                            "a graph walk)",
        "bound_ms": b_ms, "bound_by": b_by,
        **({"home": home} if home else {}),
    }


def adc_valid_rows(n: int, gen, n_valid: int | None = None):
    """Row validity: about 1% of rows masked, or exactly n_valid valid."""
    import torch
    if n_valid is None:
        return torch.rand(n, generator=gen, device="cuda") > 0.01
    ok = torch.zeros(n, dtype=torch.bool, device="cuda")
    ok[torch.randperm(n, generator=gen, device="cuda")[:n_valid]] = True
    return ok


def adc_outputs_equal(got, want, what: str) -> float:
    """Exact equality of ids and distances (bit-equal floats); returns
    the largest |distance difference| (0)."""
    import torch
    torch.cuda.synchronize()
    same_i = torch.equal(got[1], want[1])
    same_d = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    if not (same_i and same_d and got[0].dtype == want[0].dtype):
        agree = float((got[1] == want[1]).float().mean())
        raise AssertionError(f"{what} disagrees with its plain version: ids "
                             f"equal in {agree} of slots, dists bit-equal "
                             f"{same_d}")
    return float((got[0].double() - want[0].double()).abs().max())


def adc_split(name: str, call, masked, reps: int = 20) -> dict:
    """Device time of a fused ADC call split into scan, selection and
    merge (torch.profiler, by kernel: the scan kernel and the merge
    kernel).  `masked` is the same call with every row masked: its scan
    kernel stages the codes and computes every distance but offers no key,
    so its time is the scan alone and the rest of the scan kernel's time
    with the rows as given is the selection."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    def by_kernel(fn) -> dict:
        events = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=reps),
                     on_trace_ready=lambda p: events.extend(p.key_averages())
                     ) as prof:
            for _ in range(reps + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        out = {}                # ms a launch, over the launches it saw
        for stage in ("scan", "merge"):
            seen = [ev for ev in events
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and f"{stage}_kernel" in ev.key and ev.count > 0
                    and getattr(ev, "self_device_time_total", 0) > 0]
            if seen:
                out[stage] = (sum(ev.self_device_time_total for ev in seen)
                              / 1e3 / sum(ev.count for ev in seen))
        if set(out) != {"scan", "merge"}:
            raise AssertionError(f"{name}: the profiler saw {out}, not the "
                                 f"scan and merge kernels")
        return out
    real, alone = by_kernel(call), by_kernel(masked)
    return {"phase": "adc_split", "kernel": name, "reps": reps,
            "scan_kernel_ms": real["scan"], "scan_ms": alone["scan"],
            "selection_ms": real["scan"] - alone["scan"],
            "merge_ms": real["merge"], "merge_ms_rows_masked": alone["merge"]}


def check_sq_adc(nq: int, n: int, d: int, kp: int, gen,
                 n_valid: int | None = None,
                 home: str | None = None) -> dict:
    """K4 against its plain version: random int8 codes (the last 1% of
    rows repeat the first, so exact ties between distinct ids occur),
    their norms, ~1% of rows masked (or exactly n_valid valid).  The
    record names the route and plan the wrapper took (first pass)."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.adc_topk import adc_topk
    dev = torch.device("cuda")
    q8 = torch.randint(-127, 128, (nq, d), generator=gen, device=dev,
                       dtype=torch.int8)
    c8 = torch.randint(-127, 128, (n, d), generator=gen, device=dev,
                       dtype=torch.int8)
    dup = n // 100
    if dup:
        c8[n - dup:] = c8[:dup]
    cn = (c8.to(torch.int32) ** 2).sum(1, dtype=torch.int32)
    ok = adc_valid_rows(n, gen, n_valid)
    args = (q8, c8, cn, ok, kp)
    got = adc_topk.sq_adc_topk(*args)
    want = adc_topk.plain_sq_adc_topk(*args)
    err = adc_outputs_equal(got, want, f"sq_adc_topk at nq={nq} n={n} d={d}")
    kpp = min(kp, n)
    _, plan, route = adc_topk._sq_layout(
        d, nq, n, common.pass_sizes(kpp, adc_topk.MAX_KP)[0], dev,
        False, c8.data_ptr() % 16 == 0)
    nbytes = nq * d + n * d + 4.0 * n + n + 12.0 * nq * kpp
    b_ms, b_by = bound(2.0 * nq * n * d, nbytes, PEAK_INT8_OPS)
    rec = {
        "name": f"adc_topk.sq_adc_topk[nq={nq},n={n},d={d},kp={kp}"
                + (f",valid={n_valid}]" if n_valid is not None else "]"),
        "route": "cuda",
        "source": "src/repro_torch/csrc/adc_topk.cu",
        "replaces": "src/repro/kernels/adc_topk/adc_topk.py:192",
        "max_abs_err": err, "id_agreement": 1.0,
        "empty_slots": int((got[1] < 0).sum()),
        "ms": device_ms(lambda: adc_topk.sq_adc_topk(*args)),
        "plain_ms": device_ms(lambda: adc_topk.plain_sq_adc_topk(*args),
                              reps=10, warmup=2),
        "bound_ms": b_ms, "bound_by": b_by,
        "k4_route": route._asdict(), "k4_plan": [plan.chunk_rows, plan.G],
        **({"home": home} if home else {}),
    }
    none = torch.zeros_like(ok)
    log(json.dumps(adc_split(
        rec["name"], lambda: adc_topk.sq_adc_topk(*args),
        lambda: adc_topk.sq_adc_topk(q8, c8, cn, none, kp))))
    c8t = c8.T
    big = adc_topk.INT_BIG

    def library():
        d_ = cn[None, :] - 2 * torch._int_mm(q8, c8t)
        return torch.topk(torch.where(ok[None, :], d_, big), kpp, dim=1,
                          largest=False)
    try:
        library()
        rec["library_ms"] = device_ms(library)
        rec["library_call"] = ("torch._int_mm(q8, c8.T), cn - 2 cross, "
                               "torch.topk(largest=False)")
    except RuntimeError as exc:          # _int_mm refuses some shapes
        rec["library_ms"] = None
        rec["library_call"] = f"none: torch._int_mm refused ({exc})"[:200]
    return rec


def check_pq_adc(nq: int, m: int, n: int, kp: int, gen,
                 home: str | None = None) -> dict:
    """K5 against its plain version: random tables (half of the entries
    integer-valued, so equal sums occur) and codes, ~1% of rows masked."""
    import torch
    from repro_torch.kernels.adc_topk import adc_topk
    dev = torch.device("cuda")
    lut = 100.0 * torch.rand((nq, m, 256), generator=gen, device=dev)
    lut[:, :, ::2] = lut[:, :, ::2].round()
    codes_t = torch.randint(0, 256, (m, n), generator=gen, device=dev,
                            dtype=torch.uint8)
    ok = adc_valid_rows(n, gen)
    args = (lut, codes_t, ok, kp)
    got = adc_topk.pq_adc_topk(*args)
    want = adc_topk.plain_pq_adc_topk(*args)
    err = adc_outputs_equal(got, want, f"pq_adc_topk at nq={nq} m={m} n={n}")
    kpp = min(kp, n)
    nbytes = m * n + n + 4.0 * nq * m * 256 + 12.0 * nq * kpp
    b_ms, b_by = bound(float(nq) * n * m, nbytes)
    name = f"adc_topk.pq_adc_topk[nq={nq},m={m},n={n},kp={kp}]"
    none = torch.zeros_like(ok)
    log(json.dumps(adc_split(
        name, lambda: adc_topk.pq_adc_topk(*args),
        lambda: adc_topk.pq_adc_topk(lut, codes_t, none, kp))))
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/csrc/adc_topk.cu",
        "replaces": "src/repro/kernels/adc_topk/adc_topk.py:249",
        "max_abs_err": err, "id_agreement": 1.0,
        "ms": device_ms(lambda: adc_topk.pq_adc_topk(*args)),
        "plain_ms": device_ms(lambda: adc_topk.plain_pq_adc_topk(*args),
                              reps=10, warmup=2),
        "library_ms": None,
        "library_call": "none (no PyTorch call sums table look-ups and "
                        "selects the top-k in one)",
        "bound_ms": b_ms, "bound_by": b_by,
        **({"home": home} if home else {}),
    }


def check_sq_encode(nq: int, d: int) -> dict:
    """K4's query operand quantized on the card against numpy's
    `SQCodebook.encode_query` (the codes the port made on the host before)
    and against its plain version: bit-equal codes over ciphertext-like
    queries with every third row on half-steps of the grid and every fifth
    saturating.  Beside the kernel's device time, the host-clock time of
    the old operand (numpy encode, pageable upload of the codes) and of
    the new one (pageable upload of the float32 queries, the kernel)."""
    import torch
    from repro_torch.core import adc
    from repro_torch.kernels.adc_topk import adc_topk
    rng = np.random.default_rng(nq * d)
    cb = adc.SQCodebook.train(
        (40.0 * rng.standard_normal((8192, d))).astype(np.float32))
    off, s = cb.offset.astype(np.float64), cb.scale
    Q = (45.0 * rng.standard_normal((nq, d))).astype(np.float32)
    Q[::3] = off + (rng.integers(-128, 128, Q[::3].shape) + 0.5) * s
    Q[::5] = off + rng.choice([-1.0, 1.0], Q[::5].shape) * 300.0 * s
    want = cb.encode_query(Q)
    Qd = torch.from_numpy(Q).cuda()
    offset = torch.from_numpy(cb.offset).cuda()
    args = (Qd, offset, cb.scale)
    got = adc_topk.sq_encode_queries(*args)
    plain = adc_topk.plain_sq_encode_queries(*args)
    torch.cuda.synchronize()
    wrong = int((got.cpu().numpy() != want).sum())
    if wrong or not torch.equal(got, plain):
        raise AssertionError(f"sq_encode_queries at nq={nq} d={d}: {wrong} "
                             f"codes differ from encode_query, plain equal "
                             f"{torch.equal(got, plain)}")
    b_ms, b_by = bound(3.0 * nq * d, 5.0 * nq * d + 4.0 * d)
    return {
        "name": f"adc_topk.sq_encode_queries[nq={nq},d={d}]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/adc_topk.cu",
        "replaces": "none: src/repro/core/adc.py SQCodebook.encode_query "
                    "(numpy, on the host)",
        "codes_equal_encode_query": True, "max_abs_err": 0,
        "ms": device_ms(lambda: adc_topk.sq_encode_queries(*args)),
        "plain_ms": device_ms(
            lambda: adc_topk.plain_sq_encode_queries(*args), reps=10,
            warmup=2),
        "bound_ms": b_ms, "bound_by": b_by,
        "host_ms_encode_query_upload": host_ms(
            lambda: torch.from_numpy(cb.encode_query(Q)).to("cuda"), 30),
        "host_ms_upload_kernel": host_ms(
            lambda: adc_topk.sq_encode_queries(
                torch.from_numpy(Q).to("cuda"), offset, cb.scale), 30),
        "library_ms": None,
        "library_call": "none (no one PyTorch call quantizes: the plain "
                        "version is four)",
    }


# --------------------------------------------------------------- phase 3

def run_batches(eng, Q, T, stats=None):
    ids, lat = [], []
    for s in range(0, Q.shape[0], BATCH):
        t0 = time.perf_counter()
        out, st = eng.search_batch(Q[s:s + BATCH], T[s:s + BATCH], K,
                                   ratio_k=RATIO_K, ef_search=EF_SEARCH)
        lat.append(time.perf_counter() - t0)      # ids are on the host
        ids.append(out)
        if stats is not None:
            stats.append(st)
    return np.concatenate(ids), lat


def k1600_path(eng, Q, T, k: int, path: str, n_batches: int = 4):
    """`n_batches` batches of 32 at ratio_k 8 and a k that makes 1600
    candidates (the flat filter's k' = 8 k; int8 and pq8 oversample by 2
    and 4), above the fused top-k kernels' 1024 a pass: once through the
    kernels, once with them swapped for their plain versions.  The
    filter's candidate ids must be equal: K4 and K5 are bit-equal, slot
    for slot; K1 sums in another fp32 order, which may swap neighbours
    within an ulp of each other, so its candidates are held as each
    query's set (>= 99.9% of them).  The final ids, after the refine,
    must agree in >= 99.9% of slots.  -> the launches."""
    import torch
    f = eng.backend
    kp = k * RATIO_K
    batches = [(Q[s:s + BATCH], T[s:s + BATCH])
               for s in range(0, n_batches * BATCH, BATCH)]
    eng.search_batch(*batches[0], k, ratio_k=RATIO_K)          # warm-up

    def run():
        ids, lat, cands = [], [], []
        for Qb, Tb in batches:
            t0 = time.perf_counter()
            out, _ = eng.search_batch(Qb, Tb, k, ratio_k=RATIO_K)
            lat.append(time.perf_counter() - t0)
            ids.append(out)
        for Qb, _ in batches:
            cands.append(f.candidates(np.asarray(Qb, np.float32), kp,
                                      EF_SEARCH)[0])
        torch.cuda.synchronize()
        return np.concatenate(ids), lat, torch.cat(cands)

    reset_launches()
    ids, lat, cand = run()
    launches = kernel_launches()
    with plain_kernels():
        ids_p, lat_p, cand_p = run()
    if kernel_launches() != launches:
        raise AssertionError("a kernel launched during the plain run")
    exact = f.name != "flat"
    if exact:
        cand_agree = float((cand == cand_p).float().mean())
    else:
        cand_agree = float(sum(torch.isin(a, b).sum() for a, b in
                               zip(cand, cand_p))) / cand.numel()
    agree = float((ids == ids_p).mean())
    rec = {"phase": "k1600", "path": path, "k": k,
           "candidates_per_query": int(cand.shape[1]),
           "batches": n_batches, "candidate_id_agreement": cand_agree,
           "candidates_compared_as": "slots" if exact else "sets",
           "id_agreement": agree,
           "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "batch_p50_ms_plain": float(np.percentile(lat_p, 50)) * 1e3,
           "launches_per_batch": {kk: v / n_batches
                                  for kk, v in launches.items() if v}}
    log(json.dumps(rec))
    if (cand.shape[1] != 1600 or agree < MIN_ID_AGREEMENT
            or cand_agree < (1.0 if exact else MIN_ID_AGREEMENT)):
        raise AssertionError(f"{path} at k' 1600: candidates "
                             f"{cand.shape[1]}, candidate ids "
                             f"{cand_agree}, final ids {agree}")
    return launches


def profile_steps(step, n_steps: int, unit: str = "batch") -> dict:
    """Device time by kernel over a short window of `n_steps` calls of
    `step(i)` (torch.profiler), and the device's busy share of that
    window.  One call runs first as the profiler's warm-up step: the
    tracer loses activity at its start, which on a path of few kernels a
    step can be a whole step.  The profiler's own host cost lengthens
    the window, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    events = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps),
                 on_trace_ready=lambda p: events.extend(p.key_averages())
                 ) as prof:
        for i in range(n_steps + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            step(i)
            if i == n_steps:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    kernels = []
    for ev in events:
        dev_us = getattr(ev, "self_device_time_total", 0)
        if (ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0
                and not ev.key.startswith("ProfilerStep")):   # step ranges
            kernels.append((dev_us / 1e3 / n_steps, ev.count / n_steps,
                            ev.key[:60]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {
        f"device_busy_ms_per_{unit}": busy_ms if kernels else None,
        f"profiled_wall_ms_per_{unit}": wall_ms / n_steps,
        "device_idle_share_upper_bound":
            1 - busy_ms * n_steps / wall_ms if kernels else None,
        f"top_kernels_ms_per_{unit}": [
            {"kernel": name, "ms": ms, "launches": cnt}
            for ms, cnt, name in kernels[:8]],
    }


def profile_batches(eng, Q, T, n_batches: int = 2) -> dict:
    """`profile_steps` over main-path batches of the engine."""
    def step(i):
        s = i * BATCH % Q.shape[0]
        eng.search_batch(Q[s:s + BATCH], T[s:s + BATCH], K,
                         ratio_k=RATIO_K, ef_search=EF_SEARCH)
    return {"phase": "profile", "batches": n_batches,
            **profile_steps(step, n_batches)}


def small_reference_check():
    """The card's engines against the host's plain versions on a small
    database encrypted by the numpy path, through the filters of every
    ported path (f32 flat and IVF, ADC flat and IVF in int8 and pq8, the
    graph filter in f32, int8 and pq8): the ids must agree."""
    from repro_torch.core import dcpe, ppanns
    from repro_torch.core.hnsw import HNSW
    from repro_torch.data import synth
    from repro_torch.graph import GraphFilter
    from repro_torch.serving.search_engine import SecureSearchEngine
    ds = synth.make_dataset("sift1m", n=3000, n_queries=32, k_gt=K, seed=5)
    owner = ppanns.DataOwner(d=ds.d, sap_beta=dcpe.suggest_beta(
        ds.base, 0.03), seed=5)
    db = owner.encrypt_database(ds.base, build_index=False)
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    index = HNSW(ds.d, M=GRAPH_M, ef_construction=GRAPH_EF_CONSTRUCTION,
                 seed=8).build(db.C_sap)
    ivf = dict(n_partitions=IVF_PARTITIONS, nprobe=IVF_NPROBE)
    filters = {      # engine arguments, made anew for each engine
        "flat": lambda: {},
        "ivf": lambda: dict(backend="ivf", **ivf),
        "adc-flat-int8": lambda: dict(quantization="int8"),
        "adc-flat-pq8": lambda: dict(quantization="pq8"),
        "adc-ivf-int8": lambda: dict(backend="ivf", quantization="int8",
                                     **ivf),
        "adc-ivf-pq8": lambda: dict(backend="ivf", quantization="pq8",
                                    **ivf),
        "graph": lambda: dict(backend=GraphFilter(index)),
        "adc-graph-int8": lambda: dict(
            backend=GraphFilter(index, quantization="int8")),
        "adc-graph-pq8": lambda: dict(
            backend=GraphFilter(index, quantization="pq8")),
    }
    out = {}
    for name, kw in filters.items():
        got, _ = SecureSearchEngine(db.C_sap, db.C_dce, **kw()).search_batch(
            Q, T, K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        want, _ = SecureSearchEngine(db.C_sap, db.C_dce, device="cpu",
                                     **kw()).search_batch(
            Q, T, K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        out[name] = {"id_agreement_card_vs_host":
                     float((got == want).mean()),
                     "recall@10": synth.recall_at_k(got, ds.gt, K)}
    log(json.dumps({"phase": "small_reference", "n": ds.n,
                    "queries": Q.shape[0], "filters": out}))
    bad = {k: v for k, v in out.items()
           if v["id_agreement_card_vs_host"] < MIN_ID_AGREEMENT}
    if bad:
        raise AssertionError(f"card and host ids disagree: {bad}")


def flat_corpus(n: int, n_queries: int) -> dict:
    """Phase 3's corpus and queries, made in phase 1: the synthetic
    SIFT-width rows encrypted on the card, the queries by a `User`."""
    from repro_torch.core import dcpe, ppanns
    from repro_torch.data import synth

    t0 = time.perf_counter()
    ds = synth.make_dataset("sift1m", n=n, n_queries=n_queries, k_gt=K)
    t_data = time.perf_counter() - t0
    owner = ppanns.DataOwner(d=ds.d, sap_beta=dcpe.suggest_beta(
        ds.base, 0.03))
    t0 = time.perf_counter()
    C_sap, C_dce = owner.encrypt_vectors(ds.base)          # on the card
    t_enc = time.perf_counter() - t0
    user = ppanns.User(owner.share_keys())
    t0 = time.perf_counter()
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    t_query_enc = time.perf_counter() - t0
    log(json.dumps({"phase": "setup", "n": ds.n, "d": ds.d,
                    "queries": Q.shape[0], "dataset_s": t_data,
                    "encrypt_vectors_s": t_enc, "encrypt_rows_per_s":
                    ds.n / t_enc, "user_encrypt_queries_s": t_query_enc}))
    return {"ds": ds, "C_sap": C_sap, "C_dce": C_dce, "Q": Q, "T": T,
            "keys": owner.keys}


def train_pq(C_sap: np.ndarray, m: int, seed: int):
    """Worker process: the pq8 codebook of phase 4's ADC pq8 engine
    (`ADCFilter`'s own `train_codebook` and `encode` calls, host numpy)
    and its codes, with their seconds."""
    from repro_torch.core import adc
    t0 = time.perf_counter()
    book = adc.train_codebook(C_sap, "pq8", m=m, seed=seed)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = book.encode(C_sap)
    return book, codes, t_train, time.perf_counter() - t0


@contextlib.contextmanager
def pq_from_worker(ctx: dict, out: dict):
    """Phase 4's pq8 engine takes the codebook and codes `train_pq`
    made over the same rows in a worker since phase 1 (the script's
    longest host step, ~9 min at 1M rows, off the critical path); any
    other rows train here as usual.  The worker's seconds go to `out`."""
    from repro_torch.core import adc
    book, codes, out["codebook_train_s"], out["codebook_encode_s"] = \
        ctx["pq_job"].get(timeout=1200)
    out["codebook_in_worker"] = True
    train, encode = adc.train_codebook, adc.PQCodebook.encode
    mine = lambda C: C is ctx["C_sap"]

    def trained(C, quantization, **kw):
        return (book if mine(C) and quantization == "pq8"
                else train(C, quantization, **kw))

    def encoded(self, C):
        return codes if self is book and mine(C) else encode(self, C)
    adc.train_codebook, adc.PQCodebook.encode = trained, encoded
    try:
        yield
    finally:
        adc.train_codebook, adc.PQCodebook.encode = train, encode


def main_path(ctx: dict) -> dict:
    import torch
    from repro_torch.data import synth
    from repro_torch.serving.search_engine import SecureSearchEngine
    ds, C_sap, C_dce, Q, T = (ctx[k] for k in ("ds", "C_sap", "C_dce",
                                               "Q", "T"))
    n = ds.n

    eng = SecureSearchEngine(C_sap, C_dce, backend="flat")   # device: card
    t0 = time.perf_counter()
    eng.search_batch(Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K)   # upload
    t_warm = time.perf_counter() - t0

    reset_launches()
    ids, lat = run_batches(eng, Q, T)
    launches = kernel_launches()
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()

    with plain_kernels():
        ids_plain, lat_plain = run_batches(eng, Q, T)
    if kernel_launches() != launches:
        raise AssertionError("a kernel launched during the plain run")

    log(json.dumps(profile_batches(eng, Q, T)))

    rec = synth.recall_at_k(ids, ds.gt, K)
    rec_plain = synth.recall_at_k(ids_plain, ds.gt, K)
    agree = float((ids == ids_plain).mean())
    total = sum(lat)
    out = {
        "phase": "main_path", "n": ds.n, "d": ds.d, "queries": Q.shape[0],
        "batch": BATCH, "k": K, "k_prime": K * RATIO_K,
        "recall@10": rec, "recall@10_plain": rec_plain,
        "id_agreement": agree,
        "qps": Q.shape[0] / total,
        "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "qps_plain": Q.shape[0] / sum(lat_plain),
        "batch_p50_ms_plain": float(np.percentile(lat_plain, 50)) * 1e3,
        "batch_p99_ms_plain": float(np.percentile(lat_plain, 99)) * 1e3,
        "first_batch_with_upload_s": t_warm,
        "device_resident_bytes": resident, "device_peak_bytes": peak,
        "launches": launches,
    }
    log(json.dumps(out))
    if ids.shape != (Q.shape[0], K) or (ids < 0).any() or (ids >= n).any():
        raise AssertionError("main path returned ids outside the database")
    nb = len(lat)
    if (launches["l2_topk.knn"] != nb
            or launches["dce_comp.refine_topk"] != nb):
        raise AssertionError(f"flat path kernels: {launches} for {nb} "
                             f"batches (one fused scan and one fused "
                             f"refine a batch)")
    if agree < MIN_ID_AGREEMENT or abs(rec - rec_plain) > MAX_RECALL_GAP:
        raise AssertionError(f"kernel and plain runs disagree: ids "
                             f"{agree}, recall {rec} vs {rec_plain}")
    on_k1600 = k1600_path(eng, Q, T, 200, "flat_k1600")
    # the ADC paths search the same ciphertexts and queries
    ctx["ids"] = ids
    ctx["flat_stats"] = {k: out[k] for k in ("qps", "batch_p50_ms",
                                             "batch_p99_ms")}
    return launches, on_k1600, ctx


# The secure-scan step's operand forms on phase 3's corpus: the dtype of
# (C_sap, C_dce, Q_sap, T_q).  The reference's bf16 cells round all four.
SCAN_FORMS = {"scan_1m_float32": ("float32",) * 4,
              "scan_1m_filter_bf16": ("bfloat16", "float32", "bfloat16",
                                      "float32"),
              "scan_1m_bf16": ("bfloat16",) * 4}


def scan_forms(ctx: dict) -> dict:
    """Phase 3's corpus through the secure-scan step
    (`build_secure_scan_step_gspmd`: one K1 over the 1M rows and one K2 a
    batch of 32, k' 80) with its operands in each of SCAN_FORMS, K1 and K2
    reading the 16-bit ones in place: recall@10 of each.  The float32
    form's ids must equal the flat engine's in >= MIN_ID_AGREEMENT of
    slots; the all-bf16 form's must equal the float32 step's on float32
    copies of the bf16 values in every slot (the same fp32 arithmetic).
    -> {form: launches on its run}."""
    import torch
    from repro_torch.data import synth
    from repro_torch.serving.secure_scan import build_secure_scan_step_gspmd
    ds, C_sap, C_dce, Q, T = (ctx[k] for k in ("ds", "C_sap", "C_dce",
                                               "Q", "T"))
    dev = torch.device("cuda", 0)
    step = build_secure_scan_step_gspmd([dev], k=K, k_prime=K * RATIO_K)
    ops = [torch.as_tensor(C_sap, device=dev),
           torch.as_tensor(C_dce, device=dev),
           torch.as_tensor(Q, device=dev), torch.as_tensor(T, device=dev)]

    def run(args):
        ids = [step(args[0], args[1], args[2][s:s + BATCH],
                    args[3][s:s + BATCH])
               for s in range(0, Q.shape[0], BATCH)]
        return torch.cat(ids).cpu().numpy()

    on, out, ids_by = {}, {"phase": "scan_forms", "n": ds.n, "d": ds.d,
                           "queries": Q.shape[0], "batch": BATCH, "k": K,
                           "k_prime": K * RATIO_K}, {}
    for form, dts in SCAN_FORMS.items():
        args = [a if dt == "float32" else a.to(getattr(torch, dt))
                for a, dt in zip(ops, dts)]
        reset_launches()
        t0 = time.perf_counter()
        ids = run(args)
        out[f"wall_s_{form}"] = time.perf_counter() - t0
        on[form] = kernel_launches()
        ids_by[form] = ids
        out[f"recall@10_{form}"] = synth.recall_at_k(ids, ds.gt, K)
        out[f"operand_dtypes_{form}"] = dict(zip(
            ("C_sap", "C_dce", "Q_sap", "T_q"), dts))
        out[f"operand_bytes_{form}"] = sum(a.nbytes for a in args)
        if form == "scan_1m_bf16":
            with untallied():
                ids_up = run([a.float() for a in args])
            out["bf16_ids_equal_float32_copy"] = float(
                (ids == ids_up).mean())
        del args
    nb = -(-Q.shape[0] // BATCH)
    out["id_agreement_float32_vs_engine"] = float(
        (ids_by["scan_1m_float32"] == ctx["ids"]).mean())
    for form in SCAN_FORMS:
        out[f"final_ids_shared_with_float32_{form}"] = float(np.mean([
            len(set(a) & set(b)) / K for a, b in zip(
                ids_by[form].tolist(), ids_by["scan_1m_float32"].tolist())]))
    out["launches"] = on
    log(json.dumps(out))
    bad = [f for f, c in on.items() if c["l2_topk.knn"] != nb
           or c["dce_comp.refine_topk"] != nb]
    if (bad or out["id_agreement_float32_vs_engine"] < MIN_ID_AGREEMENT
            or out["bf16_ids_equal_float32_copy"] != 1.0
            or any((i < 0).any() or (i >= ds.n).any()
                   for i in ids_by.values())):
        raise AssertionError(f"scan forms on phase 3's corpus: {out}")
    return on


# --------------------------------------------------------------- phase 4

@contextlib.contextmanager
def timed_codebook(out: dict):
    """Host seconds of an ADC filter's codebook training and of encoding
    the corpus with it (wrapped around the filter's attach)."""
    from repro_torch.core import adc
    train = adc.train_codebook
    encodes = {cls: cls.encode for cls in (adc.SQCodebook, adc.PQCodebook)}

    def timed_train(*a, **kw):
        t0 = time.perf_counter()
        book = train(*a, **kw)
        out["codebook_train_s"] = time.perf_counter() - t0
        return book

    def timed(encode):
        def timed_encode(self, C):
            t0 = time.perf_counter()
            codes = encode(self, C)
            out["codebook_encode_s"] = time.perf_counter() - t0
            return codes
        return timed_encode
    adc.train_codebook = timed_train
    for cls, encode in encodes.items():
        cls.encode = timed(encode)
    try:
        yield
    finally:
        adc.train_codebook = train
        for cls, encode in encodes.items():
            cls.encode = encode


def adc_breakdown(eng, Q, T, reps: int = 10) -> dict:
    """Host-clock time of one flat ADC batch and of its stages run alone
    on the same queries (each ended by a synchronize; medians of reps):
    the filter, the query operand with its upload (int8: the float32
    queries up, codes made on the card; pq8: the codebook's tables made
    on the host, then up), the fused kernel, and
    the refine of the filter's candidates; and the device time of the
    kernel and of the refine."""
    import torch
    from repro_torch.serving.search_engine import refine_candidates
    f = eng.backend
    Qb = np.asarray(Q[:BATCH], np.float32)
    kp = K * RATIO_K
    kp2 = min(f.oversampled(kp), f._n)
    dev = f._ok.device
    qop = f.codes.query_operand(Qb, dev)
    kernel = lambda: f.codes.knn(qop, kp2, f._ok)
    cand, valid, _ = f.candidates(Qb, kp, EF_SEARCH)
    Tq = torch.as_tensor(np.asarray(T[:BATCH], np.float32)).to(dev)
    refine = lambda: refine_candidates(eng._C_dce_dev, cand, Tq, valid, K)
    return {
        "phase": "adc_breakdown", "backend": f.name, "batch": BATCH,
        "reps": reps,
        "search_batch_ms": host_ms(lambda: eng.search_batch(
            Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K), reps),
        "filter_candidates_ms": host_ms(
            lambda: f.candidates(Qb, kp, EF_SEARCH), reps),
        "query_operand_ms": host_ms(
            lambda: f.codes.query_operand(Qb, dev), reps),
        "kernel_ms": host_ms(kernel, reps),
        "kernel_device_ms": device_ms(kernel),
        "refine_ms": host_ms(refine, reps),
        "refine_device_ms": device_ms(refine),
    }


def adc_path(ctx: dict, quantization: str, backend: str = "flat") -> dict:
    """The quantized filter on the flat path's ciphertexts and queries:
    `SecureSearchEngine(backend=..., quantization=...)` on the card, once
    through the kernels and once with them swapped for their plain
    versions on the same engine, so the codebook is trained once."""
    import torch
    from repro_torch.data import synth
    from repro_torch.serving.search_engine import SecureSearchEngine
    ds, Q, T = ctx["ds"], ctx["Q"], ctx["T"]
    ivf = backend == "ivf"
    path = f"ivf_{quantization}" if ivf else f"adc_{quantization}"
    kw = dict(n_partitions=IVF_PARTITIONS, nprobe=IVF_NPROBE) if ivf else {}
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng = SecureSearchEngine(ctx["C_sap"], ctx["C_dce"], backend=backend,
                             quantization=quantization, **kw)   # the card
    wall = {}
    t0 = time.perf_counter()
    with (pq_from_worker(ctx, wall) if quantization == "pq8"
          else timed_codebook(wall)):
        eng._ensure_attached()           # codebook, codes, C_DCE upload
    wall["attach_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.search_batch(Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K)
    wall["first_batch_s"] = time.perf_counter() - t0

    reset_launches()
    stats = []
    ids, lat = run_batches(eng, Q, T, stats)
    launches = kernel_launches()
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    nq, nb = Q.shape[0], len(lat)
    rec = synth.recall_at_k(ids, ds.gt, K)
    totals = {f: int(sum(getattr(st, f) for st in stats))
              for f in ("filter_dist_evals", "filter_bytes_scanned",
                        "refine_comparisons")}
    out = {
        "phase": "adc_path", "path": path, "backend": eng.backend.name,
        "n": ds.n, "d": ds.d, "queries": nq, "batch": BATCH, "k": K,
        "k_prime": K * RATIO_K,
        "candidates_refined_per_query": eng.backend.oversampled(K * RATIO_K),
        "recall@10": rec,
        "qps": nq / sum(lat),
        "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "search_stats": totals,
        "filter_bytes_per_row_per_batch":
            totals["filter_bytes_scanned"] / (nb * ds.n),
        "launches": launches,
        "launches_per_batch": {k: v / nb for k, v in launches.items()},
        "device_resident_bytes": resident - before,
        "device_peak_bytes": peak - before,
        "wall_s": wall,
    }
    if ivf:
        out.update(n_partitions=IVF_PARTITIONS, nprobe=IVF_NPROBE)
    with plain_kernels():
        ids_plain, lat_plain = run_batches(eng, Q, T)
    if kernel_launches() != launches:
        raise AssertionError("a kernel launched during the plain run")
    rec_plain = synth.recall_at_k(ids_plain, ds.gt, K)
    agree = float((ids == ids_plain).mean())
    out.update({
        "recall@10_plain": rec_plain, "id_agreement": agree,
        "qps_plain": nq / sum(lat_plain),
        "batch_p50_ms_plain": float(np.percentile(lat_plain, 50)) * 1e3,
        "batch_p99_ms_plain": float(np.percentile(lat_plain, 99)) * 1e3,
    })
    log(json.dumps(dict(profile_batches(eng, Q, T, n_batches=4), path=path)))
    if not ivf:                          # the breakdown times the flat scan
        log(json.dumps(adc_breakdown(eng, Q, T)))
    log(json.dumps(out))
    if ids.shape != (nq, K) or (ids < 0).any() or (ids >= ds.n).any():
        raise AssertionError(f"{path} returned ids outside the database")
    kern = ("adc_topk.sq_adc_topk" if quantization == "int8"
            else "adc_topk.pq_adc_topk")
    if (launches["dce_comp.refine_topk"] != nb
            or (not ivf and launches[kern] != nb)):
        raise AssertionError(f"{path} kernels: {launches} for {nb} batches")
    if agree < MIN_ID_AGREEMENT or abs(rec - rec_plain) > MAX_RECALL_GAP:
        raise AssertionError(f"{path}: kernel and plain runs disagree: ids "
                             f"{agree}, recall {rec} vs {rec_plain}")
    ctx[f"ids_{path}"] = ids             # phase 8's sharded int8 run
    if ivf:
        return launches, None
    return launches, k1600_path(eng, Q, T, {"int8": 100, "pq8": 50}[
        quantization], f"{path}_k1600")


# --------------------------------------------------------------- phase 5

def build_hnsw(C_sap: np.ndarray, M: int, ef_construction: int, seed: int):
    """Worker process: the owner's HNSW build over C_SAP (host numpy),
    and its seconds."""
    from repro_torch.core.hnsw import HNSW
    t0 = time.perf_counter()
    index = HNSW(C_sap.shape[1], M=M, ef_construction=ef_construction,
                 seed=seed).build(C_sap)
    return index, time.perf_counter() - t0


def graph_setup(n: int, n_queries: int, pool) -> dict:
    """The graph path's corpus and queries, encrypted on the card, and
    the HNSW build over C_SAP started in `pool`."""
    from repro_torch.core import dcpe, ppanns
    from repro_torch.data import synth
    t0 = time.perf_counter()
    ds = synth.make_dataset("sift1m", n=n, n_queries=n_queries, k_gt=K)
    t_data = time.perf_counter() - t0
    owner = ppanns.DataOwner(d=ds.d, sap_beta=dcpe.suggest_beta(
        ds.base, 0.03), seed=OWNER_SEED)
    t0 = time.perf_counter()
    C_sap, C_dce = owner.encrypt_vectors(ds.base)          # on the card
    t_enc = time.perf_counter() - t0
    build = pool.apply_async(build_hnsw, (C_sap, GRAPH_M,
                                          GRAPH_EF_CONSTRUCTION,
                                          OWNER_SEED + 3))
    # 1,000 rows more from the same mixture (same seed: the same cluster
    # centres), encrypted with the same keys: the graph runtime's inserts
    extra = synth.make_dataset("sift1m", n=n + 1000, n_queries=1,
                               k_gt=1).base[n:]
    extra_sap, extra_dce = owner.encrypt_vectors(extra)
    # query 0's plaintext as a row: phase 7's insert after a reload
    probe_sap, probe_dce = owner.encrypt_vectors(ds.queries[:1])
    user = ppanns.User(owner.share_keys())
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    log(json.dumps({"phase": "graph_setup", "n": ds.n, "d": ds.d,
                    "queries": Q.shape[0], "dataset_s": t_data,
                    "encrypt_vectors_s": t_enc, "hnsw_M": GRAPH_M,
                    "hnsw_ef_construction": GRAPH_EF_CONSTRUCTION}))
    return {"ds": ds, "C_sap": C_sap, "C_dce": C_dce, "Q": Q, "T": T,
            "extra_sap": extra_sap, "extra_dce": extra_dce,
            "probe_sap": probe_sap, "probe_dce": probe_dce,
            "build": build, "t_data": t_data, "t_enc": t_enc}


def graph_index(g: dict):
    """The owner's HNSW from the worker, waited for by its first user
    (phase 6's graph collection): -> (index, build seconds); the seconds
    waited go to g["t_wait"]."""
    if "index" not in g:
        t0 = time.perf_counter()
        g["index"], g["build_s"] = g["build"].get()
        g["t_wait"] = time.perf_counter() - t0
    return g["index"], g["build_s"]


@contextlib.contextmanager
def recorded_walks(out: list):
    """Keep each batch's per-query hop and edge counts (device tensors,
    no sync) and its arguments, (hops, edges, a, kw), from the graph
    walk's entry point."""
    from repro_torch.kernels.graph_expand import ops as graph_ops
    inner = graph_ops.graph_topk

    def record(*a, **kw):
        res = inner(*a, **kw)
        out.append((res[3], res[4], a, kw))
        return res
    graph_ops.graph_topk = record
    try:
        yield
    finally:
        graph_ops.graph_topk = inner


GRAPH_PLAIN_BATCHES = 4         # 16-bit walks held against the plain walk


def graph_walk_16(calls: list, dtype: str) -> tuple[dict, dict]:
    """K6 reading 16-bit rows in place, on the real graph: every batch's
    walk of the graph path (its arguments as the engine passed them) with
    C_SAP and the queries rounded to `dtype`.  Beams, distances, visited,
    hops and edges must be bit-equal to the float32 kernel on float32
    copies of the same values, and the beam ids of the first
    GRAPH_PLAIN_BATCHES batches equal to the plain walk's in >=
    MIN_ID_AGREEMENT of slots (fp32 sums in another order).  -> (the
    launches of the 16-bit run, its kernel record)."""
    import torch
    from repro_torch.graph import traverse
    from repro_torch.kernels.graph_expand import graph_expand
    t = getattr(torch, dtype)
    (n0, up, ok, (C,), _, entry, ef), kw = calls[0][0][:7], calls[0][1]
    walk_kw = dict(ef_cap=kw["ef_cap"], max_hops=kw["max_hops"])
    C16 = C.to(t)
    C32 = C16.float()
    queries = [a[4].to(t) for a, _ in calls]
    reset_launches()
    outs = [graph_expand.graph_walk(n0, up, ok, C16, Q16, entry, ef,
                                    **walk_kw) for Q16 in queries]
    torch.cuda.synchronize()
    launches = kernel_launches()
    with untallied():
        bit_equal = all(equal_outputs(o, graph_expand.graph_walk(
            n0, up, ok, C32, Q16.float(), entry, ef, **walk_kw))
            for o, Q16 in zip(outs, queries))
        plain = [graph_expand.plain_graph_walk(n0, up, ok, C16, Q16, entry,
                                               ef, **walk_kw)
                 for Q16 in queries[:GRAPH_PLAIN_BATCHES]]
        agree = float(torch.cat([(o[0] == w[0]).float().flatten()
                                 for o, w in zip(outs, plain)]).mean())
        Q0 = queries[0]
        ms = device_ms(lambda: graph_expand.graph_walk(
            n0, up, ok, C16, Q0, entry, ef, **walk_kw))
        ms32 = device_ms(lambda: graph_expand.graph_walk(
            n0, up, ok, C32, Q0.float(), entry, ef, **walk_kw))
        plain_ms = device_ms(lambda: graph_expand.plain_graph_walk(
            n0, up, ok, C16, Q0, entry, ef, **walk_kw), reps=3, warmup=1)
    if not bit_equal or agree < MIN_ID_AGREEMENT:
        raise AssertionError(f"K6 on {dtype} rows of the real graph: "
                             f"bit-equal to the float32 kernel {bit_equal}, "
                             f"beam ids = plain walk's in {agree}")
    hops, edges = outs[0][3], outs[0][4]
    _, _, up_hops, up_edges = traverse.upper_entry(up, ok, (C16,), Q0, entry)
    R, M0 = n0.shape
    M = up.shape[2] if up.dim() == 3 and up.shape[0] else 0
    d = C.shape[1]
    b_ms, b_by = graph_expand_bound(hops - up_hops, edges - up_edges, R, M0,
                                    d, walk_kw["ef_cap"], up_hops, up_edges,
                                    M, esize=C16.element_size())
    nq = Q0.shape[0]
    rec = {"name": f"graph_expand.graph_walk[nq={nq},R={R},M0={M0},M={M},"
                   f"LU={up.shape[0]},d={d},ef={ef},"
                   f"ef_cap={walk_kw['ef_cap']},{dtype}]",
           "row_dtype": dtype, "route": "cuda",
           "source": "src/repro_torch/csrc/graph_expand.cu",
           "replaces": "src/repro/kernels/graph_expand/graph_expand.py:234",
           "also_replaces": "src/repro/graph/traverse.py:141",
           "graph": "the graph path's HNSW over its C_SAP", "batches":
           len(calls), "bit_equal_to_float32_kernel": bit_equal,
           "plain_batches": len(plain), "beam_id_agreement_plain": agree,
           "max_abs_err": float((outs[0][1] - plain[0][1]).abs()[
               torch.isfinite(plain[0][1])].max()),
           "max_hops_per_query": int(hops.max()),
           "mean_hops_per_query": float(hops.float().mean()),
           "ms": ms, "ms_float32_copy": ms32, "plain_ms": plain_ms,
           "plain_reps": 3, "library_ms": None,
           "library_call": "none (no PyTorch call runs a graph walk)",
           "bound_ms": b_ms, "bound_by": b_by,
           "home": f"graph_{'bf16' if dtype == 'bfloat16' else 'f16'}"}
    return launches, rec


def graph_breakdown(eng, Q, T, reps: int = 10) -> dict:
    """Host-clock time of one graph batch and of its parts run alone on
    the same queries (each ended by a synchronize; medians of `reps`):
    the filter, the fused walk (one graph_walk launch), the scan trace's
    download (the (nq, R) bool trace that the filter downloads, and the
    alternative: the kernel's packed words, 32x fewer bytes, unpacked on
    the host), and, as the parent's "before", the torch upper-layer descent
    (`traverse.upper_entry`, a host sync a greedy step) and the layer-0
    entry alone from its endpoints.  Device times and bounds of the fused
    walk and the layer-0 entry on the real graph, and the time a hop over
    the batch's longest chain."""
    import torch
    from repro_torch.graph import beam_plan, traverse
    from repro_torch.kernels.graph_expand import graph_expand
    gf = eng.backend
    Qb = torch.from_numpy(np.asarray(Q[:BATCH], np.float32)).to(
        gf._db[0].device)
    kp = K * RATIO_K
    ef, ef_cap, max_hops = beam_plan(kp, max(EF_SEARCH, kp))
    C = gf._db[0]
    R, M0 = gf._neigh0.shape
    M = gf._neigh_up.shape[2]
    d = Qb.shape[1]

    def timed(fn):
        return host_ms(fn, reps)

    walk = lambda: graph_expand.graph_walk(
        gf._neigh0, gf._neigh_up, gf._ok, C, Qb, gf.csr.entry, ef,
        ef_cap=ef_cap, max_hops=max_hops)
    upper = lambda: traverse.upper_entry(gf._neigh_up, gf._ok, gf._db, Qb,
                                         gf.csr.entry)
    ep, ep_d, up_hops, up_edges = upper()
    layer0 = lambda: graph_expand.expand_layer0(
        gf._neigh0, gf._ok, C, Qb, ep, ep_d, ef, ef_cap=ef_cap,
        max_hops=max_hops)
    _, _, visited, hops, edges = walk()
    # the kernel's (nq, ceil(R/32)) words, packed again from the trace
    pad = torch.zeros((visited.shape[0], -R % 32), dtype=torch.bool,
                      device=visited.device)
    bits = torch.cat([visited, pad], 1).view(visited.shape[0], -1, 32)
    words = (bits.int() << torch.arange(32, device=bits.device,
                                        dtype=torch.int32)).sum(
        -1, dtype=torch.int32)
    unpacked = lambda: np.unpackbits(
        words.cpu().numpy().view(np.uint8), axis=1,
        bitorder="little")[:, :R].astype(bool)
    if not np.array_equal(unpacked(), visited.cpu().numpy()):
        raise AssertionError("packed scan trace differs from the bool one")
    _, _, _, l0_hops, l0_edges = layer0()
    b_walk, b_walk_by = graph_expand_bound(hops - up_hops, edges - up_edges,
                                           R, M0, d, ef_cap, up_hops,
                                           up_edges, M)
    b_l0, b_l0_by = graph_expand_bound(l0_hops, l0_edges, R, M0, d, ef_cap)
    walk_dev = device_ms(walk)
    return {
        "phase": "graph_breakdown", "batch": BATCH, "reps": reps,
        "search_batch_ms": timed(lambda: eng.search_batch(
            Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K, ef_search=EF_SEARCH)),
        "filter_candidates_ms": timed(lambda: gf.candidates(
            Q[:BATCH], kp, EF_SEARCH)),
        "graph_walk_ms": timed(walk),
        "graph_walk_device_ms": walk_dev,
        "graph_walk_bound_ms": b_walk, "graph_walk_bound_by": b_walk_by,
        "graph_walk_us_per_hop": 1e3 * walk_dev / int(hops.max()),
        "trace_download_ms": timed(lambda: visited.cpu()),
        "trace_packed_download_unpack_ms": timed(unpacked),
        "before_torch_descent_ms": timed(upper),
        "expand_layer0_ms": timed(layer0),
        "expand_layer0_device_ms": device_ms(layer0),
        "expand_layer0_bound_ms": b_l0, "expand_layer0_bound_by": b_l0_by,
        "expand_layer0_us_per_hop":
            1e3 * device_ms(layer0) / max(1, int(l0_hops.max())),
        "hops_per_query_mean": float(hops.float().mean()),
        "hops_per_query_max": int(hops.max()),
        "upper_hops_per_query_mean": float(up_hops.float().mean()),
        "layer0_hops_per_query_mean": float(l0_hops.float().mean()),
        "layer0_edges_per_query_mean": float(l0_edges.float().mean()),
    }


@contextlib.contextmanager
def counted_descents(out: list):
    """Count the torch upper-layer descents (`traverse.upper_entry`)."""
    from repro_torch.graph import traverse
    inner = traverse.upper_entry

    def counted(*a, **kw):
        out.append(1)
        return inner(*a, **kw)
    traverse.upper_entry = counted
    try:
        yield
    finally:
        traverse.upper_entry = inner


def graph_path(g: dict) -> dict:
    import warnings

    import torch
    from repro_torch.data import synth
    from repro_torch.graph import GraphFilter
    from repro_torch.serving.search_engine import (HNSWGraphFilter,
                                                   SecureSearchEngine)
    ds, Q, T = g["ds"], g["Q"], g["T"]
    index, build_s = graph_index(g)
    t_wait = g["t_wait"]
    log(json.dumps({"phase": "graph_build", "n": index.size,
                    "hnsw_M": GRAPH_M,
                    "hnsw_ef_construction": GRAPH_EF_CONSTRUCTION,
                    "build_s": build_s, "waited_for_build_s": t_wait,
                    "layers": len(index.links)}))

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng = SecureSearchEngine(g["C_sap"], g["C_dce"],
                             backend=GraphFilter(index))      # the card
    t0 = time.perf_counter()
    eng.search_batch(Q[:BATCH], T[:BATCH], K, ratio_k=RATIO_K,
                     ef_search=EF_SEARCH)        # CSR mirror + upload
    t_warm = time.perf_counter() - t0

    reset_launches()
    walks, stats, descents = [], [], []
    t0 = time.perf_counter()
    with recorded_walks(walks), counted_descents(descents):
        ids, lat = run_batches(eng, Q, T, stats)
    t_run = time.perf_counter() - t0
    launches = kernel_launches()
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    with plain_kernels():
        ids_plain, lat_plain = run_batches(eng, Q, T)
    t_plain = time.perf_counter() - t0
    if kernel_launches() != launches:
        raise AssertionError("a kernel launched during the plain run")

    prof = profile_batches(eng, Q, T)
    log(json.dumps(dict(prof, path="graph")))
    log(json.dumps(graph_breakdown(eng, Q, T)))

    t0 = time.perf_counter()
    oracle = SecureSearchEngine(g["C_sap"], g["C_dce"],
                                backend=HNSWGraphFilter(index))
    with warnings.catch_warnings():         # the host walk is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        ids_host, _ = run_batches(oracle, Q[:ORACLE_QUERIES],
                                  T[:ORACLE_QUERIES])
    t_oracle = time.perf_counter() - t0

    hops = torch.cat([w[0] for w in walks]).cpu().numpy()
    edges = torch.cat([w[1] for w in walks]).cpu().numpy()
    rec = synth.recall_at_k(ids, ds.gt, K)
    rec_plain = synth.recall_at_k(ids_plain, ds.gt, K)
    agree = float((ids == ids_plain).mean())
    nq = Q.shape[0]
    out = {
        "phase": "graph_path", "n": ds.n, "d": ds.d, "queries": nq,
        "batch": BATCH, "k": K, "k_prime": K * RATIO_K,
        "ef_search": EF_SEARCH, "hnsw_M": GRAPH_M,
        "hnsw_ef_construction": GRAPH_EF_CONSTRUCTION,
        "recall@10": rec, "recall@10_plain": rec_plain,
        "id_agreement": agree,
        "host_walk_queries": ORACLE_QUERIES,
        "host_walk_id_agreement": float(
            (ids[:ORACLE_QUERIES] == ids_host).mean()),
        "recall@10_host_walk": synth.recall_at_k(
            ids_host, ds.gt[:ORACLE_QUERIES], K),
        "qps": nq / sum(lat),
        "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "qps_plain": nq / sum(lat_plain),
        "batch_p50_ms_plain": float(np.percentile(lat_plain, 50)) * 1e3,
        "batch_p99_ms_plain": float(np.percentile(lat_plain, 99)) * 1e3,
        "hops_per_query_mean": float(hops.mean()),
        "hops_per_query_max": int(hops.max()),
        "edges_per_query_mean": float(edges.mean()),
        "edges_per_query_max": int(edges.max()),
        "search_stats": {f: int(sum(getattr(st, f) for st in stats))
                         for f in ("filter_dist_evals", "n_hops",
                                   "n_edges_scanned", "filter_bytes_scanned",
                                   "refine_comparisons")},
        "launches": launches, "torch_descents": len(descents),
        "device_resident_bytes": resident - before,
        "device_peak_bytes": peak - before,
        "device_bytes_held_before_the_engine": before,
        "build_s": build_s,
        "wall_s": {"dataset": g["t_data"], "encrypt_vectors": g["t_enc"],
                   "hnsw_build": build_s,
                   "waited_for_build": t_wait,
                   "first_batch_with_csr_and_upload": t_warm,
                   "kernel_run": t_run, "plain_run": t_plain,
                   "host_walk_oracle": t_oracle},
    }
    log(json.dumps(out))
    g["recall_global"] = rec            # beside phase 8's sharded graph
    if ids.shape != (nq, K) or (ids < 0).any() or (ids >= ds.n).any():
        raise AssertionError("graph path returned ids outside the database")
    if (launches["graph_expand.graph_walk"] != len(lat)
            or launches["graph_expand.expand_layer0"] != 0
            or launches["dce_comp.refine_topk"] != len(lat) or descents):
        raise AssertionError(f"graph path kernels: {launches} and "
                             f"{len(descents)} torch descents for "
                             f"{len(lat)} batches (one graph_walk and one "
                             f"refine_topk a batch, no torch descent)")
    if agree < MIN_ID_AGREEMENT or abs(rec - rec_plain) > MAX_RECALL_GAP:
        raise AssertionError(f"kernel and plain runs disagree: ids "
                             f"{agree}, recall {rec} vs {rec_plain}")
    # K6 reading 16-bit rows of the same graph: paths graph_bf16, graph_f16
    g["half_paths"], g["half_records"] = {}, []
    for dtype in HALF_DTYPES:
        on16, rec16 = graph_walk_16([w[2:] for w in walks], dtype)
        g["half_paths"][rec16["home"]] = on16
        g["half_records"].append(rec16)
    return launches


# --------------------------------------------------------------- phase 6

RT_THREADS = 8                  # client threads of the scheduler passes
RT_WINDOW = 32                  # requests a client keeps in flight
RT_BURSTS = 10                  # insert bursts of the live-ingestion run
RT_DELETES = 1000               # rows deleted on the flat and int8 runs


def drive_clients(col, Q, T, n_threads: int = RT_THREADS,
                  window: int = RT_WINDOW):
    """`n_threads` client threads, each submitting its share of the
    queries through the collection's scheduler in windows of `window`
    requests and waiting for each window.  -> (ids (nq, K) in query
    order, the engine calls' latencies, wall seconds).  A client's
    failure is raised here."""
    import threading
    nq = Q.shape[0]
    ids = np.full((nq, K), -2, np.int64)
    calls, errors = {}, []
    share = -(-nq // n_threads)

    def client(lo, hi):
        try:
            for s in range(lo, hi, window):
                futs = [(i, col.submit(Q[i], T[i], K, ratio_k=RATIO_K,
                                       ef_search=EF_SEARCH,
                                       want_stats=True))
                        for i in range(s, min(s + window, hi))]
                for i, fut in futs:
                    row, st = fut.result(timeout=300)
                    ids[i] = row
                    calls[id(st)] = st      # held: ids stay unique
        except BaseException as exc:         # re-raised by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client,
                                args=(t * share, min(nq, (t + 1) * share)))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or (ids == -2).any():
        raise AssertionError("a client thread did not finish")
    return ids, [st.latency_s for st in calls.values()], wall


def against_plain(col, Q, T, ids, what: str) -> dict:
    """The same queries through the same collection with the kernels
    swapped for their plain versions: ids must agree in >= 99.9% of
    slots, and no kernel may launch."""
    before = kernel_launches()
    with plain_kernels():
        plain, _ = run_batches(col, Q, T)
    if kernel_launches() != before:
        raise AssertionError(f"{what}: a kernel launched during the plain "
                             f"run")
    agree = float((ids == plain).mean())
    if agree < MIN_ID_AGREEMENT:
        raise AssertionError(f"{what}: kernel and plain ids agree in "
                             f"{agree} of slots")
    return {"id_agreement_plain": agree,
            "ids_equal_plain": bool((ids == plain).all())}


def deleted_returned(ids, gone) -> int:
    return int(np.isin(ids, gone).sum())


def backend_device_bytes(b) -> int:
    """Bytes of the device tensors a runtime backend holds (the refine
    array included)."""
    held = [b._C_main, b._C_all, b._C_delta, b._C_dce_dev, b._adc_ok,
            b._g_neigh0, b._g_neigh_up, b._g_ok]
    if b.codes is not None and b.codes.arrays is not None:
        held += b.codes.arrays
    return sum(int(t.nbytes) for t in held if t is not None)


def rt_common(col, lat, wall: float, launches: dict, n_calls: int,
              audit: int) -> dict:
    """The fields every runtime_path line carries."""
    import torch
    from repro_torch.serving.runtime import jit_cache_size
    snap = col.stats()
    served = snap["n_requests"] > 0
    return {
        "rows": col.store.n_total, "rows_alive": col.store.n_alive,
        "device_resident_bytes": backend_device_bytes(col._backend),
        "device_allocated_bytes": torch.cuda.memory_allocated(),
        "engine_calls": n_calls,
        "engine_batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "engine_batch_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "launches": launches,
        "launches_per_batch": {k: v / n_calls for k, v in launches.items()
                               if v},
        "recompiles": jit_cache_size() - audit,
        "wall_s": wall,
        # sojourn exists only for requests a scheduler served; the ADC
        # and graph runs call the engine directly
        "sojourn_p50_ms": snap["p50_latency_s"] * 1e3 if served else None,
        "sojourn_p99_ms": snap["p99_latency_s"] * 1e3 if served else None,
        "telemetry": {k: snap[k] for k in (
            "qps", "n_requests", "n_batches", "n_steps", "batch_occupancy",
            "slot_occupancy", "n_inserts", "n_deletes", "n_compactions")},
    }


def delta_knn_cost(b, Q) -> dict:
    """Device time of the flat backend's two K1 calls of one batch: the
    main region and the sentinel-padded delta bucket (CUDA events; not
    counted as the path's launches)."""
    import torch
    from repro_torch.kernels.l2_topk import ops as l2_ops
    kp = K * RATIO_K
    Qd = torch.from_numpy(np.asarray(Q[:BATCH], np.float32)).to(
        b._C_main.device)
    bucket = int(b._C_delta.shape[0])
    n_main = int(b._C_main.shape[0])
    with untallied():
        delta_ms = device_ms(lambda: l2_ops.knn(
            Qd, b._C_delta, min(kp, bucket), chunk=bucket))
        main_ms = device_ms(lambda: l2_ops.knn(Qd, b._C_main, kp,
                                               chunk=min(4096, n_main)))
    return {"delta_rows": b._delta_n, "delta_bucket": bucket,
            "main_rows": n_main, "knn_delta_device_ms": delta_ms,
            "knn_main_device_ms": main_ms}


def runtime_flat(ctx: dict, scheduler: str, ref: dict | None,
                 phase2_ms: dict) -> tuple[dict, dict]:
    """(a)-(b), or (c) with `ref` the flush run's checkpoints: a keyless
    flat collection over phase 3's first 990,000 rows, client threads
    through the scheduler, then live ingestion: 10 bursts of 1,000 of the
    held-out rows (a batch after each: two K1 calls while the delta is
    non-empty), compaction to phase 3's 1M rows, and 1,000 deletes.
    -> (checkpoint ids, launches)."""
    import torch
    from repro_torch.obs import profile_kernels
    from repro_torch.serving.runtime import (CollectionManager,
                                             jit_cache_size)
    Q, T, C_sap, C_dce = ctx["Q"], ctx["T"], ctx["C_sap"], ctx["C_dce"]
    n = C_sap.shape[0]
    n0 = n - RT_BURSTS * 1000
    flush = scheduler == "flush"
    path = "flat_flush" if flush else "flat_continuous"
    t_start = time.perf_counter()
    mgr = CollectionManager()                          # device: the card
    col = mgr.create_collection(
        "t0", "sift", C_sap.shape[1], backend="flat", keyless=True,
        max_batch=BATCH, max_wait_ms=2, compact_every=1_000_000,
        scheduler=scheduler)
    t0 = time.perf_counter()
    col.load_snapshot(C_sap[:n0], C_dce[:n0])
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    col.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
    t_warm = time.perf_counter() - t0
    audit = jit_cache_size()
    cp, lat, checks = {}, [], {}

    # (a) / (c): client threads through the scheduler
    reset_launches()
    ids, calls, wall = drive_clients(col, Q, T)
    lat += calls
    n_calls = len(calls)
    cp["clients"] = ids
    snap = col.stats()
    rec_a = {"phase": "runtime_path", "path": path, "scheduler": scheduler,
             "step": "clients", "threads": RT_THREADS,
             "window": RT_WINDOW, "queries": Q.shape[0],
             "qps_wall": Q.shape[0] / wall,
             "qps_telemetry": snap["qps"],
             "load_snapshot_s": t_load, "warmup_s": t_warm}
    direct, lat_d = run_batches(col, Q, T)       # the direct engine path
    lat += lat_d
    n_calls += Q.shape[0] // BATCH
    rec_a["id_agreement_direct"] = float((ids == direct).mean())
    if ref is not None:
        rec_a["id_agreement_flush"] = float((ids == ref["clients"]).mean())
    rec_a.update(rt_common(col, lat, time.perf_counter() - t_start,
                           kernel_launches(), n_calls, audit))
    log(json.dumps(rec_a))
    if (ids != direct).any() or (ref is not None
                                 and (ids != ref["clients"]).any()):
        raise AssertionError(f"{path}: scheduler ids differ from the "
                             f"direct engine's or the flush run's")

    if flush:
        # (f) one flush pass under the kernel profiler
        with profile_kernels() as prof:
            _, calls_f, _ = drive_clients(col, Q, T)
        lat += calls_f
        n_calls += len(calls_f)
        prof_line = {"phase": "runtime_profile", "path": path,
                     "engine_calls": len(calls_f), "kernels": {}}
        for name, s in sorted(prof.summary().items()):
            prof_line["kernels"][name] = {
                "calls": s["calls"],
                "cuda_event_ms_per_call": s["total_s"] * 1e3 / s["calls"],
                "bytes_per_call": s["total_bytes"] / s["calls"],
                "phase2_device_ms": phase2_ms.get(name)}
        log(json.dumps(prof_line))

    # (b) live ingestion
    gen_check, lat_b = [], []
    served = [0, 0.0]               # queries searched in (b), seconds
    for b in range(RT_BURSTS):
        lo = n0 + 1000 * b
        col.insert_encrypted(C_sap[lo:lo + 1000], C_dce[lo:lo + 1000])
        s = (BATCH * b) % Q.shape[0]
        k1 = kernel_launches()["l2_topk.knn"]
        t0 = time.perf_counter()
        if flush:
            out, lat_d = run_batches(col, Q[s:s + BATCH], T[s:s + BATCH])
            lat_b += lat_d
            n_calls += 1
        else:
            out, calls, _ = drive_clients(col, Q[s:s + BATCH],
                                          T[s:s + BATCH], window=4)
            lat_b += calls
            n_calls += len(calls)
        served[0] += BATCH
        served[1] += time.perf_counter() - t0
        gen_check.append(kernel_launches()["l2_topk.knn"] - k1)
        cp[f"burst{b}"] = out
    if flush and gen_check != [2] * RT_BURSTS:
        raise AssertionError(f"K1 calls a batch with a live delta: "
                             f"{gen_check} (two expected: main and delta)")
    def search():
        """All queries: direct batches (flush run) or client threads
        through the slot loop (continuous run); -> (ids, engine calls)."""
        t0 = time.perf_counter()
        if flush:
            out, calls = run_batches(col, Q, T)
            lat_b.extend(calls)
        else:
            out, calls, _ = drive_clients(col, Q, T)
            lat_b.extend(calls)
        served[0] += Q.shape[0]
        served[1] += time.perf_counter() - t0
        return out, len(calls)

    cp["bursts_done"], c = search()
    n_calls += c
    if flush:
        checks["bursts_done"] = against_plain(col, Q, T, cp["bursts_done"],
                                              f"{path} after the bursts")
        delta_cost = delta_knn_cost(col._backend, Q)
        delta_cost["batch_p50_ms_with_delta"] = float(
            np.percentile(lat_b[-c:], 50)) * 1e3
    col.compact()
    cp["compacted"], c = search()
    n_calls += c
    if flush:
        delta_cost["batch_p50_ms_compacted"] = float(
            np.percentile(lat_b[-c:], 50)) * 1e3
    phase3 = ctx["ids"]
    checks["compacted"] = {
        "id_agreement_phase3": float((cp["compacted"] == phase3).mean()),
        "ids_equal_phase3": bool((cp["compacted"] == phase3).all())}
    if checks["compacted"]["id_agreement_phase3"] < MIN_ID_AGREEMENT:
        raise AssertionError(f"{path}: compacted ids against phase 3's: "
                             f"{checks['compacted']}")
    if ref is None:
        rng = np.random.default_rng(OWNER_SEED + 11)
        seen = np.unique(cp["compacted"])
        seen = seen[seen >= 0]
        hit = rng.choice(seen, size=min(300, seen.size), replace=False)
        rest = np.setdiff1d(np.arange(n), hit)
        gone = np.concatenate([hit, rng.choice(rest, RT_DELETES - hit.size,
                                               replace=False)])
    else:
        gone = ref["gone"]
    cp["gone"] = gone
    col.delete(gone)
    cp["deleted"], c = search()
    n_calls += c
    launches = kernel_launches()
    if flush:
        checks["deleted"] = against_plain(col, Q, T, cp["deleted"],
                                          f"{path} after the deletes")
    n_back = deleted_returned(cp["deleted"], gone)
    checks["deleted"] = dict(checks.get("deleted", {}),
                             deleted_ids_returned=n_back,
                             deleted_ids_in_compacted_answers=int(
                                 np.isin(gone, cp["compacted"]).sum()))
    if ref is not None:
        for key in ("bursts_done", "compacted", "deleted",
                    *(f"burst{b}" for b in range(RT_BURSTS))):
            agree = float((cp[key] == ref[key]).mean())
            checks.setdefault("continuous_vs_flush", {})[key] = agree
            if agree < 1.0:
                raise AssertionError(f"continuous ids differ from flush at "
                                     f"{key}: {agree}")
    rec_b = {"phase": "runtime_path", "path": path,
             "scheduler": scheduler, "step": "clients+ingest",
             "bursts": RT_BURSTS, "burst_rows": 1000,
             "deletes": len(gone), "checks": checks,
             "k1_calls_per_burst_batch": gen_check,
             "deleted_ids_returned": n_back,
             "qps_ingest_searches": served[0] / served[1],
             "delta_cost": delta_cost if flush else None,
             **rt_common(col, lat + lat_b, time.perf_counter() - t_start,
                         launches, n_calls, audit)}
    log(json.dumps(rec_b))
    if n_back or rec_b["recompiles"]:
        raise AssertionError(f"{path}: {n_back} deleted ids returned, "
                             f"{rec_b['recompiles']} kernel rebuilds")
    mgr.drop_collection("t0", "sift")
    del col, mgr
    gc.collect()
    torch.cuda.empty_cache()
    return cp, launches


def runtime_adc(ctx: dict, quantization: str, gone=None) -> dict:
    """(d): a keyless ADC collection (`quantization` int8 over phase 3's
    1M rows with the flat run's deletes, or pq8 over the graph corpus),
    its queries directly in batches of 32, against its plain run."""
    import torch
    from repro_torch.serving.runtime import Collection, jit_cache_size
    Q, T, C_sap, C_dce = ctx["Q"], ctx["T"], ctx["C_sap"], ctx["C_dce"]
    path = f"adc_{quantization}"
    t_start = time.perf_counter()
    col = Collection("t0", path, C_sap.shape[1], backend="flat",
                     quantization=quantization, keyless=True,
                     max_batch=BATCH, compact_every=1_000_000)
    try:
        col.load_snapshot(C_sap, C_dce)
        t0 = time.perf_counter()
        col.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        t_warm = time.perf_counter() - t0        # the codebook: at attach
        audit = jit_cache_size()
        if gone is not None:                     # the ok stream, in place
            col.delete(gone)
        reset_launches()
        ids, lat = run_batches(col, Q, T)
        launches = kernel_launches()
        checks = against_plain(col, Q, T, ids, path)
        n_back = deleted_returned(ids, gone) if gone is not None else 0
        kern = ("adc_topk.sq_adc_topk" if quantization == "int8"
                else "adc_topk.pq_adc_topk")
        nb = len(lat)
        rec = {"phase": "runtime_path", "path": path, "queries": Q.shape[0],
               "qps": Q.shape[0] / sum(lat),
               "warmup_with_codebook_s": t_warm,
               "deletes": 0 if gone is None else len(gone),
               "deleted_ids_returned": n_back, "checks": checks,
               **rt_common(col, lat, time.perf_counter() - t_start,
                           launches, nb, audit)}
        log(json.dumps(rec))
        if (n_back or rec["recompiles"] or launches[kern] != nb
                or launches["dce_comp.refine_topk"] != nb):
            raise AssertionError(f"{path}: {rec}")
    finally:
        col.close()
    del col
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def runtime_graph(g: dict) -> dict:
    """(e): a keyless graph collection over phase 1's corpus and HNSW
    (`load_snapshot(graph_arrays=...)`), 1% of its rows deleted (K6 walks
    past rows with ok = 0), then the 1,000 rows phase 1 held out inserted
    (host HNSW inserts, CSR rows refreshed); all queries against the
    plain torch walk."""
    import torch
    from repro_torch.serving.runtime import Collection, jit_cache_size
    Q, T, C_sap, C_dce = g["Q"], g["T"], g["C_sap"], g["C_dce"]
    index, _ = graph_index(g)
    n = C_sap.shape[0]
    t_start = time.perf_counter()
    col = Collection("t0", "graph", C_sap.shape[1], backend="graph",
                     keyless=True, max_batch=BATCH, compact_every=1_000_000,
                     hnsw_M=GRAPH_M, hnsw_ef_construction=GRAPH_EF_CONSTRUCTION)
    try:
        t0 = time.perf_counter()
        col.load_snapshot(C_sap, C_dce, graph_arrays=index.to_arrays())
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        col.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)   # CSR mirror
        t_warm = time.perf_counter() - t0
        audit = jit_cache_size()
        gone = np.random.default_rng(OWNER_SEED + 13).choice(
            n, n // 100, replace=False)
        t0 = time.perf_counter()
        col.delete(gone)                     # ok = 0 rows, repaired rows
        t_delete = time.perf_counter() - t0
        reset_launches()
        ids_d, lat = run_batches(col, Q, T)
        launches = kernel_launches()
        checks = {"deleted": against_plain(col, Q, T, ids_d,
                                           "graph after the deletes")}
        t0 = time.perf_counter()
        col.insert_encrypted(g["extra_sap"], g["extra_dce"])  # host HNSW
        t_insert = time.perf_counter() - t0
        reset_launches()
        ids, lat_i = run_batches(col, Q, T)
        lat += lat_i
        launches = {k: v + launches[k] for k, v in kernel_launches().items()}
        checks["inserted"] = against_plain(col, Q, T, ids,
                                           "graph after the inserts")
        n_back = deleted_returned(ids_d, gone) + deleted_returned(ids, gone)
        nb = len(lat)
        rec = {"phase": "runtime_path", "path": "graph",
               "queries": Q.shape[0], "qps": 2 * Q.shape[0] / sum(lat),
               "deletes": len(gone), "inserts": g["extra_sap"].shape[0],
               "deleted_ids_returned": n_back,
               "inserted_ids_returned": int((ids >= n).sum()),
               "checks": checks,
               "host_s": {"load_snapshot": t_load, "warmup_csr": t_warm,
                          "delete": t_delete, "insert": t_insert},
               **rt_common(col, lat, time.perf_counter() - t_start,
                           launches, nb, audit)}
        log(json.dumps(rec))
        if (n_back or rec["recompiles"]
                or launches["graph_expand.graph_walk"] != nb
                or launches["dce_comp.refine_topk"] != nb):
            raise AssertionError(f"graph runtime: {rec}")
    finally:
        col.close()
    del col
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def runtime_paths(corpus: dict, graph: dict, records: list) -> dict:
    """Phase 6: the serving runtime on the card.  -> launches by path."""
    phase2_ms = {}
    for r in records:
        if r["name"] == f"l2_topk.knn[nq={BATCH},n=1000000,d=128," \
                        f"k={K * RATIO_K}]":
            phase2_ms["l2_topk.knn"] = r["ms"]
        if r["name"].startswith(f"dce_comp.refine_topk[B={BATCH},"
                                f"n={K * RATIO_K},"):
            phase2_ms["dce_comp.refine_topk"] = r["ms"]
    t0 = time.perf_counter()
    cp, on_flat = runtime_flat(corpus, "flush", None, phase2_ms)
    _, on_cont = runtime_flat(corpus, "continuous", cp, phase2_ms)
    on_int8 = runtime_adc(corpus, "int8", cp["gone"])
    on_pq8 = runtime_adc(graph, "pq8")
    on_graph = runtime_graph(graph)
    log(json.dumps({"phase": "runtime_done",
                    "wall_s": time.perf_counter() - t0}))
    return {"runtime_flat": on_flat, "runtime_flat_continuous": on_cont,
            "runtime_int8": on_int8, "runtime_pq8": on_pq8,
            "runtime_graph": on_graph}


# --------------------------------------------------------------- phase 7

API_THREADS = 8                 # client threads of the coalesced pass
API_PER_THREAD = 128            # single-query requests each submits (at
                                # most: --queries / 8 on a short run)
# the leakage harness's replay scale (BENCH_attacks.json's leak_n,
# leak_d and leak_nq), its profiles and its backend cells
LEAK_N, LEAK_D, LEAK_NQ = 2048, 32, 64
LEAK_PROFILES = ("perf", "balanced", "hardened", "oblivious-sketch")
LEAK_IVF_CELLS = (("ivf", None), ("ivf", "int8"))


def api_params():
    from repro_torch.api import SearchParams
    return SearchParams(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)


def api_batches(svc, name: str, Q, T, wire: bool = False):
    """Every query as batch requests of 32 (coalesce=False), each through
    `SearchRequest.to_bytes` -> `from_bytes` and its result through
    `SearchResult.to_bytes` -> `from_bytes` when `wire`, as between two
    processes.  -> (ids, request seconds, request bytes, result bytes,
    seconds of each request spent packing and unpacking)."""
    from repro_torch.api import (EncryptedQuery, SearchRequest,
                                 SearchResult)
    ids, lat, wire_s, up, down = [], [], [], 0, 0
    for s in range(0, Q.shape[0], BATCH):
        req = SearchRequest(tenant="t0", collection=name,
                            query=EncryptedQuery(C_sap=Q[s:s + BATCH],
                                                 T=T[s:s + BATCH]),
                            params=api_params(), coalesce=False)
        t0 = time.perf_counter()
        if wire:
            data = req.to_bytes()
            got = SearchRequest.from_bytes(data)
            t1 = time.perf_counter()
            res = svc.submit(got)
            t2 = time.perf_counter()
            out = res.to_bytes()
            back = SearchResult.from_bytes(out)
            wire_s.append(time.perf_counter() - t2 + t1 - t0)
            up, down = up + len(data), down + len(out)
            if not (np.array_equal(back.ids, res.ids)
                    and back.stats == res.stats):
                raise AssertionError("a SearchResult changed on the wire")
            res = back
        else:
            res = svc.submit(req)
        lat.append(time.perf_counter() - t0)
        ids.append(res.ids)
    return np.concatenate(ids), lat, up, down, wire_s


def api_clients(svc, name: str, Q, T):
    """API_THREADS client threads, each submitting its share (at most
    API_PER_THREAD) of single-query requests one after another
    (coalesce=True: the collection's flush batcher shares engine calls
    between the threads), each request and result through the wire.
    -> (ids in query order, request seconds, wall seconds, request
    bytes, result bytes, seconds of each request spent packing and
    unpacking).  A client's failure, a hang included (the service's
    result timeout), is raised here."""
    import threading
    from repro_torch.api import (EncryptedQuery, SearchRequest,
                                 SearchResult)
    per = min(API_PER_THREAD, Q.shape[0] // API_THREADS)
    nq = API_THREADS * per
    ids = np.full((nq, K), -2, np.int64)
    lat, wire_s = np.zeros(nq), np.zeros(nq)
    sizes = np.zeros((nq, 2), np.int64)
    errors = []

    def client(lo, hi):
        try:
            for i in range(lo, hi):
                req = SearchRequest(tenant="t0", collection=name,
                                    query=EncryptedQuery(C_sap=Q[i:i + 1],
                                                         T=T[i:i + 1]),
                                    params=api_params())
                t0 = time.perf_counter()
                data = req.to_bytes()
                got = SearchRequest.from_bytes(data)
                t1 = time.perf_counter()
                res = svc.submit(got)
                t2 = time.perf_counter()
                out = res.to_bytes()
                ids[i] = SearchResult.from_bytes(out).ids[0]
                t3 = time.perf_counter()
                lat[i], wire_s[i] = t3 - t0, t3 - t2 + t1 - t0
                sizes[i] = len(data), len(out)
        except BaseException as exc:         # re-raised by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t * per, (t + 1) * per))
               for t in range(API_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or (ids == -2).any():
        raise AssertionError("an API client thread did not finish")
    return ids, list(lat), wall, int(sizes[:, 0].sum()), \
        int(sizes[:, 1].sum()), list(wire_s)


def ms_stats(lat) -> dict:
    return {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def api_flat(ctx: dict, tmp: Path) -> dict:
    """(a) The three roles over phase 3's corpus: the owner rebuilt
    around phase 3's keys (`DataOwner.from_keys`), its keys exported to
    a keystore, a user from that keystore with phase 3's query seed, and
    a keyless flat collection made from phase 3's ciphertexts, answering
    batch requests and coalesced single-query requests from client
    threads.  -> launches (batch and coalesced passes)."""
    import torch
    from repro_torch.api import (DataOwnerClient, EncryptedCorpus,
                                 IndexSpec, Keystore, QueryClient,
                                 SecureAnnService)
    from repro_torch.serving.runtime import jit_cache_size
    ds, keys = ctx["ds"], ctx["keys"]
    t_start = time.perf_counter()
    spec = IndexSpec(tenant="t0", name="sift", d=ds.d, backend="flat",
                     sap_beta=keys.sap_key.beta, sap_s=keys.sap_key.s,
                     seed=OWNER_SEED, max_batch=BATCH)
    owner = DataOwnerClient(spec, keys=keys)
    owner.export_keys(Keystore(tmp / "keys"))
    t0 = time.perf_counter()
    user = QueryClient.from_keystore(tmp / "keys", "t0__sift",
                                     expect_d=ds.d, seed=17)
    query = user.encrypt_queries(ds.queries)
    t_qenc = time.perf_counter() - t0
    Q, T = query.C_sap, query.T
    if not (Q.tobytes() == ctx["Q"].tobytes()
            and T.tobytes() == ctx["T"].tobytes()):
        raise AssertionError("QueryClient(seed=17) ciphertexts differ from "
                             "phase 3's User ciphertexts")
    nq = Q.shape[0]
    with SecureAnnService() as svc:                   # device: the card
        t0 = time.perf_counter()
        svc.create_collection(spec, EncryptedCorpus(C_sap=ctx["C_sap"],
                                                    C_dce=ctx["C_dce"]))
        t_create = time.perf_counter() - t0
        t0 = time.perf_counter()
        svc.warmup("t0", "sift", k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        t_warm = time.perf_counter() - t0
        audit = jit_cache_size()
        reset_launches()
        ids, lat, up, down, wire = api_batches(svc, "sift", Q, T, wire=True)
        on_batches = kernel_launches()
        ids_c, lat_c, wall_c, up_c, down_c, wire_c = api_clients(
            svc, "sift", Q, T)
        launches = kernel_launches()
        rebuilt = jit_cache_size() - audit
        snap = svc.stats("t0", "sift")
        resident = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    nb = len(lat)
    m = ids_c.shape[0]
    rec = {"phase": "api_path", "path": "api_flat", "n": ds.n, "d": ds.d,
           "queries": nq, "k": K, "k_prime": K * RATIO_K,
           "query_ciphertexts_equal_phase3": True,
           "batch": {"requests": nb, "queries_per_request": BATCH,
                     "qps": nq / sum(lat), **ms_stats(lat),
                     "wire_p50_ms": float(np.percentile(wire, 50)) * 1e3,
                     "request_bytes_per_query": up / nq,
                     "result_bytes_per_query": down / nq,
                     "id_agreement_phase3": float((ids == ctx["ids"]).mean()),
                     "launches": on_batches},
           "coalesced": {"threads": API_THREADS, "requests": m,
                         "qps": m / wall_c, **ms_stats(lat_c),
                         "wire_p50_ms": float(
                             np.percentile(wire_c, 50)) * 1e3,
                         "request_bytes_per_query": up_c / m,
                         "result_bytes_per_query": down_c / m,
                         "engine_calls": snap["n_batches"],
                         "batch_occupancy": snap["batch_occupancy"],
                         "sojourn_p50_ms": snap["p50_latency_s"] * 1e3,
                         "sojourn_p99_ms": snap["p99_latency_s"] * 1e3,
                         "id_agreement_batch": float(
                             (ids_c == ids[:m]).mean())},
           "launches": launches, "rebuilds_after_warmup": rebuilt,
           "device_allocated_bytes": resident,
           "host_s": {"user_encrypt_queries": t_qenc,
                      "create_collection": t_create, "warmup": t_warm},
           "wall_s": time.perf_counter() - t_start}
    log(json.dumps(rec))
    if not (ids == ctx["ids"]).all():
        raise AssertionError("api flat ids differ from phase 3's")
    if not (ids_c == ids[:m]).all():
        raise AssertionError("coalesced ids differ from the batch ids")
    if (on_batches["l2_topk.knn"] != nb
            or on_batches["dce_comp.refine_topk"] != nb or rebuilt):
        raise AssertionError(f"api flat: {on_batches} for {nb} batch "
                             f"requests (one fused scan and one fused "
                             f"refine each), {rebuilt} rebuilds")
    return launches


def api_persist(g: dict, tmp: Path, quantization: str | None) -> dict:
    """(b) Persistence over phase 1's graph corpus: a keyless collection
    (`backend="graph"` with the owner's HNSW arrays, or flat int8 with
    its codebook trained at attach) searched, saved to a `.ppcol`,
    closed, loaded into a fresh service and searched again; then one
    held-out row (query 0's plaintext, encrypted by phase 1's owner)
    inserted and found, and one answered id deleted and never returned.
    -> launches."""
    import torch
    from repro_torch.api import (EncryptedCorpus, IndexSpec,
                                 SecureAnnService)
    from repro_torch.kernels import _build
    Q, T = g["Q"], g["T"]
    graph = quantization is None
    path = "api_graph" if graph else f"api_{quantization}"
    index = graph_index(g)[0].to_arrays() if graph else None
    spec = IndexSpec(tenant="t0", name=path, d=Q.shape[1],
                     backend="graph" if graph else "flat",
                     quantization=quantization, seed=OWNER_SEED,
                     hnsw_M=GRAPH_M,
                     hnsw_ef_construction=GRAPH_EF_CONSTRUCTION,
                     max_batch=BATCH, compact_every=1_000_000)
    filt = "graph_expand.graph_walk" if graph else "adc_topk.sq_adc_topk"
    t_start = time.perf_counter()
    reset_launches()
    with SecureAnnService() as svc:
        t0 = time.perf_counter()
        svc.create_collection(spec, EncryptedCorpus(
            C_sap=g["C_sap"], C_dce=g["C_dce"], index=index))
        svc.warmup("t0", path, k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        t_create = time.perf_counter() - t0        # CSR mirror / codebook
        before = kernel_launches()
        ids, lat, *_ = api_batches(svc, path, Q, T)
        on_batches = {k: v - before[k] for k, v in kernel_launches().items()}
        t0 = time.perf_counter()
        (ppcol,) = svc.save(tmp / path)
        t_save = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    events = dict(_build.events)
    t0 = time.perf_counter()
    svc = SecureAnnService.load(tmp / path)
    t_load = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        first, *_ = api_batches(svc, path, Q[:BATCH], T[:BATCH])
        t_first = time.perf_counter() - t0        # upload, CSR / codes
        ids_l, lat_l, *_ = api_batches(svc, path, Q, T)
        builds = {k: v - events[k] for k, v in _build.events.items()}
        new = svc.insert("t0", path, g["probe_sap"], g["probe_dce"])
        ids_i, *_ = api_batches(svc, path, Q[:BATCH], T[:BATCH])
        gone = int(ids_l[1, 0])
        svc.delete("t0", path, [gone])
        ids_d, *_ = api_batches(svc, path, Q, T)
        launches = kernel_launches()
    finally:
        svc.close()
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    nb = len(lat)
    rec = {"phase": "api_path", "path": path, "n": g["C_sap"].shape[0],
           "queries": Q.shape[0],
           "backend": spec.backend, "quantization": quantization,
           "qps": Q.shape[0] / sum(lat), **ms_stats(lat),
           "qps_after_load": Q.shape[0] / sum(lat_l),
           "ppcol_bytes": ppcol.stat().st_size,
           "host_s": {"create_and_warmup": t_create, "save": t_save,
                      "load": t_load,
                      "first_batch_after_load": t_first},
           "id_agreement_after_load": float((ids_l == ids).mean()),
           "first_batch_after_load_equal": bool(
               (first == ids[:BATCH]).all()),
           "kernel_builds_after_load": builds,
           "inserted_row": int(new[0]),
           "inserted_row_found": bool(int(new[0]) in ids_i[0]),
           "deleted_id": gone,
           "deleted_id_returned": int((ids_d == gone).sum()),
           "launches_per_batch_before_save": {
               k: v / nb for k, v in on_batches.items() if v},
           "launches": launches,
           "wall_s": time.perf_counter() - t_start}
    log(json.dumps(rec))
    if not (ids_l == ids).all() or not rec["first_batch_after_load_equal"]:
        raise AssertionError(f"{path}: ids after load differ from the ids "
                             f"before the save")
    if any(builds.values()):
        raise AssertionError(f"{path}: kernel builds after load: {builds}")
    if not rec["inserted_row_found"] or rec["deleted_id_returned"]:
        raise AssertionError(f"{path}: insert / delete after load: {rec}")
    if on_batches[filt] != nb or on_batches["dce_comp.refine_topk"] != nb:
        raise AssertionError(f"{path}: {on_batches} for {nb} batches (one "
                             f"{filt} and one refine_topk each)")
    return launches


def leak_cell(profile: str, backend: str, quantization):
    """Worker process: one frontier cell of the leakage harness on the
    card.  -> ([AttackResult dicts], seconds)."""
    from repro_torch.sec import evaluate_profile
    t0 = time.perf_counter()
    res = evaluate_profile(profile, backend, quantization, n=LEAK_N,
                           d=LEAK_D, nq=LEAK_NQ, seed=0)
    return [r.to_dict() for r in res], time.perf_counter() - t0


def leak_trace_check() -> dict:
    """The graph collection the harness builds for its `perf` cell (the
    same data, keys, seed and per-row HNSW inserts), built here once:
    its scan trace (the graph walk's visited words, downloaded) with the
    kernels must be bit-equal to the trace with them swapped for their
    plain versions."""
    from repro_torch.core import dcpe, ppanns
    from repro_torch.data import synth
    from repro_torch.serving.runtime import Collection
    ds = synth.make_dataset("sift1m", n=LEAK_N, n_queries=LEAK_NQ,
                            d=LEAK_D, k_gt=K, seed=0)
    owner = ppanns.DataOwner(d=LEAK_D, sap_beta=dcpe.suggest_beta(
        ds.base, fraction=0.01), sap_s=1024.0, seed=0)
    user = ppanns.User(owner.share_keys(), seed=1)
    C_sap, C_dce = owner.encrypt_vectors(ds.base)            # the card
    Q, T = map(np.stack, zip(*(user.encrypt_query(q) for q in ds.queries)))
    col = Collection("leak", "perf-graph", LEAK_D, backend="graph", seed=0,
                     keyless=True, security_profile="perf")
    try:
        t0 = time.perf_counter()
        col.insert_encrypted(C_sap, C_dce)          # host HNSW inserts
        t_build = time.perf_counter() - t0
        with untallied():
            before = kernel_launches()
            col.search_batch(Q, T, K)
            walks = (kernel_launches()["graph_expand.graph_walk"]
                     - before["graph_expand.graph_walk"])
            trace = np.array(col._backend.last_scan_trace, copy=True)
            before = kernel_launches()
            with plain_kernels():
                col.search_batch(Q, T, K)
            if kernel_launches() != before:
                raise AssertionError("a kernel launched during the plain "
                                     "run")
            plain = np.array(col._backend.last_scan_trace, copy=True)
    finally:
        col.close()
    return {"graph_walk_launches": walks, "rows": LEAK_N,
            "queries": LEAK_NQ, "hnsw_build_s": t_build,
            "touched": int(trace.sum()),
            "touched_plain": int(plain.sum()),
            "bit_equal": bool(trace.shape == plain.shape
                              and np.array_equal(trace, plain))}


def leakage() -> dict:
    """(c) The leakage harness on the card at BENCH_attacks.json's
    replay scale: `evaluate_profile` for every profile x (ivf, ivf+int8,
    graph) -- the four graph cells in worker processes, whose host HNSW
    builds (per-row inserts, ~half a minute each) run beside the trace
    check and the IVF cells here -- and the bars of
    tests/test_leakage.py."""
    from repro_torch.sec import evaluate_profile
    t_start = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(LEAK_PROFILES)) as pool:
        jobs = {p: pool.apply_async(leak_cell, (p, "graph", None))
                for p in LEAK_PROFILES}
        trace = leak_trace_check()
        cells = {}
        for p in LEAK_PROFILES:
            for backend, quant in LEAK_IVF_CELLS:
                t0 = time.perf_counter()
                res = evaluate_profile(p, backend, quant, n=LEAK_N, d=LEAK_D,
                                       nq=LEAK_NQ, seed=0)
                cells[(p, res[0].backend)] = (
                    [r.to_dict() for r in res], time.perf_counter() - t0)
        for p, job in jobs.items():
            cells[(p, "graph")] = job.get(timeout=600)
    succ = {f"{p}/{b}": {r["attack"]: r["success"] for r in rs}
            for (p, b), (rs, _) in cells.items()}
    rec = {"phase": "leakage", "n": LEAK_N, "d": LEAK_D, "queries": LEAK_NQ,
           "trace_check": trace, "success": succ,
           "detail": {f"{p}/{b}": {"results": rs, "seconds": s}
                      for (p, b), (rs, s) in cells.items()},
           "wall_s": time.perf_counter() - t_start}
    bars = {
        "perf ivf access pattern leaks (>= 0.2)":
            succ["perf/ivf"]["access-pattern"] >= 0.2,
        "graph perf access pattern leaks (>= 0.15)":
            succ["perf/graph"]["access-pattern"] >= 0.15,
        "hardened and oblivious-sketch ivf at chance (<= 0.05)": all(
            v <= 0.05 for p in ("hardened", "oblivious-sketch")
            for b in ("ivf", "ivf+int8") for v in succ[f"{p}/{b}"].values()),
        "graph hardened the intermediate tier (> 0.05)":
            succ["hardened/graph"]["access-pattern"] > 0.05,
        "dce sign channel at chance everywhere (<= 0.05)": all(
            s["dce-kpa-sign"] <= 0.05 for s in succ.values()),
    }
    rec["bars"] = bars
    log(json.dumps(rec))
    if not trace["bit_equal"] or trace["graph_walk_launches"] != 1:
        raise AssertionError(f"leakage graph trace: {trace}")
    if not all(bars.values()):
        raise AssertionError(f"leakage bars: {bars}")
    return rec


def api_paths(corpus: dict, graph: dict) -> dict:
    """Phase 7: the public API and the leakage harness on the card.
    -> launches by path."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_api_") as tmp:
        tmp = Path(tmp)
        on_flat = api_flat(corpus, tmp)
        on_graph = api_persist(graph, tmp, None)
        on_int8 = api_persist(graph, tmp, "int8")
    leakage()
    log(json.dumps({"phase": "api_done",
                    "wall_s": time.perf_counter() - t0}))
    return {"api_flat": on_flat, "api_graph": on_graph, "api_int8": on_int8}


# --------------------------------------------------------------- phase 8

SHARDS = 4                      # shard groups of phase 8's collections
REPLICAS = 2                    # logical replicas a group
LOGICAL_DEVICES = 8             # placement devices forced on the one card
SHARD_SEED = OWNER_SEED         # the sharded collections' seed: shard s's
#                                 subgraph is built with SHARD_SEED + s
WAL_BURSTS = 10                 # (f): insert bursts of 100 rows, then
WAL_DELETES = 100               # 100 deletes, then a crash before fsync


def shard_rows(n: int, n_shards: int = SHARDS) -> int:
    """Rows a shard of a sharded collection over n rows holds: the
    port's `serving.sharded.shard_bucket` (the store's power-of-two
    bucket, minimum 256, split evenly), copied so phase 1 can start the
    subgraph builds before the port is imported."""
    b = 256
    while b < n:
        b <<= 1
    return -(-b // n_shards) * n_shards // n_shards


def start_shard_graphs(g: dict, pool) -> None:
    """Phase 1: the per-shard subgraphs of phase 8's graph collection
    (shard s: the rows of its block, M 8, ef_construction 48, seed
    SHARD_SEED + s — what the sharded backend builds itself), each in a
    worker process beside the owner's global build."""
    n = g["C_sap"].shape[0]
    per = shard_rows(n)
    g["shard_builds"] = [
        pool.apply_async(build_hnsw, (g["C_sap"][s * per:(s + 1) * per],
                                      GRAPH_M, GRAPH_EF_CONSTRUCTION,
                                      SHARD_SEED + s))
        for s in range(SHARDS)]


def sharded_placement(n_shards: int = SHARDS):
    from repro_torch.api import PlacementSpec
    return PlacementSpec(kind="sharded", n_shards=n_shards,
                         n_replicas=REPLICAS)


def shard_ids_out(ids, per: int, shard: int) -> int:
    """Answered ids that lie in `shard`'s rows."""
    return int(((ids >= shard * per) & (ids < (shard + 1) * per)).sum())


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lat_stats(lat) -> dict:
    return {"qps": BATCH * len(lat) / sum(lat),
            "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3}


def sharded_collection(C_sap, C_dce, name: str, n_shards: int = SHARDS,
                       **kw):
    """A keyless sharded collection on the card over the rows given."""
    from repro_torch.serving.runtime import Collection
    col = Collection("t0", name, C_sap.shape[1], keyless=True,
                     seed=SHARD_SEED, max_batch=BATCH,
                     compact_every=1_000_000,
                     placement=sharded_placement(n_shards), **kw)
    col.load_snapshot(C_sap, C_dce)
    col.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
    return col


def sharded_flat(ctx: dict, n_shards: int) -> tuple[dict, object]:
    """(a) phase 3's rows in a flat collection of `n_shards` groups: its
    ids must equal phase 3's flat ids in every slot, with K1 once per
    shard and K2 once a batch, and agree with its plain run as phase 3's
    did.  -> (record with launches, the collection: the caller closes
    it)."""
    from repro_torch.serving.runtime import jit_cache_size
    Q, T = ctx["Q"], ctx["T"]
    t0 = time.perf_counter()
    col = sharded_collection(ctx["C_sap"], ctx["C_dce"],
                             f"sharded_flat_{n_shards}", n_shards,
                             backend="flat")
    t_load = time.perf_counter() - t0
    audit = jit_cache_size()
    reset_launches()
    ids, lat = run_batches(col, Q, T)
    launches = kernel_launches()
    nb = len(lat)
    checks = against_plain(col, Q, T, ids, f"sharded flat {n_shards}")
    log(json.dumps(dict(profile_batches(col, Q, T),
                        path=f"sharded_flat_{n_shards}")))
    rec = {"phase": "sharded_path", "step": "a", "path": "sharded_flat",
           "n": ctx["C_sap"].shape[0], "shards": n_shards,
           "replicas": REPLICAS, "logical_devices": LOGICAL_DEVICES,
           "queries": Q.shape[0], **lat_stats(lat),
           "phase3": ctx["flat_stats"],
           "id_agreement_phase3": float((ids == ctx["ids"]).mean()),
           "checks": checks, "load_and_warmup_s": t_load,
           "launches_per_batch": {k: v / nb for k, v in launches.items()
                                  if v},
           "launches": launches, "recompiles": jit_cache_size() - audit}
    log(json.dumps(rec))
    if (ids != ctx["ids"]).any():
        raise AssertionError(f"sharded flat ({n_shards} shards): ids differ "
                             f"from phase 3's in {1 - rec['id_agreement_phase3']}"
                             f" of slots")
    if (launches["l2_topk.knn"] != n_shards * nb
            or launches["dce_comp.refine_topk"] != nb):
        raise AssertionError(f"sharded flat: {launches} for {nb} batches "
                             f"({n_shards} K1 and one K2 a batch)")
    rec["ids"] = ids
    return rec, col


def near_ties(col, Q, T, ids, plain) -> dict:
    """Traces each query whose kernel and plain ids differ to a near-tie.
    Its batch's candidates are taken again through the kernels and
    through the plain versions.  Where the two candidate sets differ,
    every id in their symmetric difference must lie within L2_RTOL *
    (||q||^2 + ||x||^2) of the kernel's k'-th candidate (fp64 distances):
    an fp32 near-tie at the k' boundary.  Where they are equal, the
    refine differs, and one of the candidates the two answers rank
    differently must meet another with |Z| <= Z_RTOL * max|Z| (plain Z):
    a near-zero DCE comparison.  -> counts; `unexplained` must be 0."""
    import torch
    from repro_torch.kernels.dce_comp import dce_comp
    b = col._backend
    X = col.store.sap_view.astype(np.float64)
    kp = K * RATIO_K
    out = {"queries": 0, "candidate_sets_differ": 0, "refine_differs": 0,
           "unexplained": 0, "max_boundary_gap": 0.0}
    for qi in np.flatnonzero((ids != plain).any(axis=1)):
        s0 = qi - qi % BATCH
        Qb = Q[s0:s0 + BATCH]
        with col._lock:
            c_k, v_k, _ = b.candidates(Qb, kp, EF_SEARCH)
            with plain_kernels():
                c_p, v_p, _ = b.candidates(Qb, kp, EF_SEARCH)
        j = qi - s0
        ck, cp = c_k[j][v_k[j]], c_p[j][v_p[j]]
        q = Q[qi].astype(np.float64)
        out["queries"] += 1
        diff = np.setxor1d(ck, cp)
        if diff.size:
            out["candidate_sets_differ"] += 1
            d = lambda r: ((X[r] - q) ** 2).sum(-1)
            scale = (q * q).sum() + (X[diff] ** 2).sum(-1)
            gap = float((np.abs(d(diff) - d(ck[-1])) / scale).max())
            out["max_boundary_gap"] = max(out["max_boundary_gap"], gap)
            out["unexplained"] += int(gap > L2_RTOL)
        else:
            out["refine_differs"] += 1
            C = torch.from_numpy(col.store.dce_view[ck][None])
            Z = dce_comp.plain_batched_z_matrix(
                C, torch.from_numpy(T[qi][None]))[0].abs()
            moved = ids[qi] != plain[qi]
            rows = np.flatnonzero(np.isin(ck, np.union1d(ids[qi][moved],
                                                         plain[qi][moved])))
            near = Z[rows] <= Z_RTOL * Z.max()
            near[np.arange(rows.size), rows] = False      # Z[i, i]
            out["unexplained"] += int(not bool(near.any()))
    return out


def sharded_failover(col, Q, T, ids0) -> dict:
    """(b) on (a)'s collection: one replica of group 1 down (ids equal,
    not degraded), the whole group down (degraded, one group down, no id
    of its rows, K1 three times a batch, kernel ids = plain ids in the
    limits of phase 3, each differing query traced to an fp32 near-tie by
    `near_ties`), both revived (ids equal (a)'s); no kernel build after
    warmup."""
    from repro_torch.serving.runtime import jit_cache_size
    audit = jit_cache_size()
    h = col.health
    per = col._backend.padded_rows // SHARDS
    out = {"phase": "sharded_path", "step": "b", "path": "sharded_flat",
           "shards": SHARDS, "replicas": REPLICAS}
    h.kill(1, 0)
    st1 = []
    ids1, _ = run_batches(col, Q, T, st1)
    out["replica_down"] = {
        "ids_equal": bool((ids1 == ids0).all()),
        "degraded": any(s.degraded for s in st1)}
    h.kill(1, 1)
    std = []
    reset_launches()
    idsd, lat = run_batches(col, Q, T, std)
    launches = kernel_launches()
    checks = against_plain(col, Q, T, idsd, "sharded flat, group down")
    if not checks["ids_equal_plain"]:
        with plain_kernels():
            plain, _ = run_batches(col, Q, T)
        checks["near_ties"] = near_ties(col, Q, T, idsd, plain)
    out["group_down"] = {
        "degraded": all(s.degraded for s in std),
        "n_shards_down": sorted({s.n_shards_down for s in std}),
        "ids_from_dead_group": shard_ids_out(idsd, per, 1),
        "id_agreement_healthy": float((idsd == ids0).mean()),
        "checks": checks, **lat_stats(lat),
        "launches_per_batch": {k: v / len(lat) for k, v in launches.items()
                               if v}}
    h.revive(1, 0)
    h.revive(1, 1)
    str_ = []
    idsr, _ = run_batches(col, Q, T, str_)
    out["revived"] = {"ids_equal": bool((idsr == ids0).all()),
                      "degraded": any(s.degraded for s in str_)}
    out["recompiles"] = jit_cache_size() - audit
    log(json.dumps(out))
    ok = (out["replica_down"]["ids_equal"]
          and not out["replica_down"]["degraded"]
          and out["group_down"]["degraded"]
          and out["group_down"]["n_shards_down"] == [1]
          and out["group_down"]["ids_from_dead_group"] == 0
          and not checks.get("near_ties", {}).get("unexplained")
          and launches["l2_topk.knn"] == (SHARDS - 1) * len(lat)
          and out["revived"]["ids_equal"] and not out["revived"]["degraded"]
          and out["recompiles"] == 0)
    if not ok:
        raise AssertionError(f"sharded failover: {out}")
    return out


def sharded_int8(ctx: dict) -> dict:
    """(c) phase 3's rows in an int8 collection of 4 groups: ids equal to
    phase 4's int8 ids in every slot (K4 is exact), K4 once per shard."""
    Q, T = ctx["Q"], ctx["T"]
    t0 = time.perf_counter()
    col = sharded_collection(ctx["C_sap"], ctx["C_dce"], "sharded_int8",
                             backend="flat", quantization="int8")
    t_load = time.perf_counter() - t0
    try:
        reset_launches()
        ids, lat = run_batches(col, Q, T)
        launches = kernel_launches()
    finally:
        col.close()
    del col
    free_card()
    nb = len(lat)
    rec = {"phase": "sharded_path", "step": "c", "path": "sharded_int8",
           "n": ctx["C_sap"].shape[0], "shards": SHARDS,
           "queries": Q.shape[0], **lat_stats(lat),
           "id_agreement_phase4": float((ids == ctx["ids_adc_int8"]).mean()),
           "load_warmup_codebook_s": t_load,
           "launches_per_batch": {k: v / nb for k, v in launches.items()
                                  if v},
           "launches": launches}
    log(json.dumps(rec))
    if (ids != ctx["ids_adc_int8"]).any():
        raise AssertionError(f"sharded int8: ids differ from phase 4's: "
                             f"{rec['id_agreement_phase4']}")
    if (launches["adc_topk.sq_adc_topk"] != SHARDS * nb
            or launches["dce_comp.refine_topk"] != nb):
        raise AssertionError(f"sharded int8: {launches} for {nb} batches")
    return launches


def sharded_vs_single(g: dict, name: str, **kw) -> tuple[dict, dict]:
    """(d) the graph corpus in a single-device collection and in a
    sharded one of 4 groups (the sharded pq8 collection takes the single
    one's codebook from its snapshot, as a reload would): ids equal in
    every slot.  -> (record, the sharded run's launches)."""
    from repro_torch.serving.runtime import Collection
    Q, T, C_sap, C_dce = g["Q"], g["T"], g["C_sap"], g["C_dce"]
    single = Collection("t0", name, C_sap.shape[1], keyless=True,
                        seed=SHARD_SEED, max_batch=BATCH,
                        compact_every=1_000_000, **kw)
    try:
        single.load_snapshot(C_sap, C_dce)
        t0 = time.perf_counter()
        single.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        t_single = time.perf_counter() - t0   # the IVF / codebook build
        want, lat_single = run_batches(single, Q, T)
        arrays, book = single.snapshot()
    finally:
        single.close()
    del single
    free_card()
    adc = {k[len("adc__"):]: v for k, v in arrays.items()
           if k.startswith("adc__")}
    col = Collection("t0", f"sharded_{name}", C_sap.shape[1], keyless=True,
                     seed=SHARD_SEED, max_batch=BATCH,
                     compact_every=1_000_000,
                     placement=sharded_placement(), **kw)
    try:
        col.load_snapshot(C_sap, C_dce, adc_state=(
            {"arrays": adc, "trained_gen": book["adc_trained_gen"]}
            if adc else None))
        col.warmup(k=K, ratio_k=RATIO_K, ef_search=EF_SEARCH)
        reset_launches()
        ids, lat = run_batches(col, Q, T)
        launches = kernel_launches()
        checks = against_plain(col, Q, T, ids, f"sharded {name}")
    finally:
        col.close()
    del col
    free_card()
    nb = len(lat)
    rec = {"phase": "sharded_path", "step": "d", "path": f"sharded_{name}",
           "n": C_sap.shape[0], "shards": SHARDS, "queries": Q.shape[0],
           **lat_stats(lat), "single": lat_stats(lat_single),
           "single_warmup_s": t_single,
           "id_agreement_single": float((ids == want).mean()),
           "checks": checks,
           "launches_per_batch": {k: v / nb for k, v in launches.items()
                                  if v},
           "launches": launches}
    log(json.dumps(rec))
    if (ids != want).any():
        raise AssertionError(f"sharded {name}: ids differ from the single "
                             f"collection's: {rec['id_agreement_single']}")
    if name == "pq8" and launches["adc_topk.pq_adc_topk"] != SHARDS * nb:
        raise AssertionError(f"sharded pq8: {launches} for {nb} batches")
    return rec, launches


def sharded_graph(g: dict, tmp: Path) -> tuple[dict, dict]:
    """(e) the graph corpus in a sharded graph collection through the
    service, its subgraphs those phase 1's workers built (handed over as
    the corpus index, `s<i>__` arrays: what `restore_graph` takes); ids
    bit-equal to the plain torch walk's, K6 once per shard.  (f, first
    half) saved to a .ppcol, closed, loaded: ids equal, no kernel build.
    -> (record, launches)."""
    from repro_torch.api import (EncryptedCorpus, IndexSpec,
                                 SecureAnnService)
    from repro_torch.data import synth
    from repro_torch.kernels import _build
    Q, T, C_sap, C_dce = g["Q"], g["T"], g["C_sap"], g["C_dce"]
    t0 = time.perf_counter()
    built = [job.get(timeout=900) for job in g["shard_builds"]]
    t_wait = time.perf_counter() - t0
    index = {f"s{s}__{k}": v for s, (h, _) in enumerate(built)
             for k, v in h.to_arrays().items()}
    spec = IndexSpec(tenant="t0", name="sharded_graph", d=C_sap.shape[1],
                     backend="graph", seed=SHARD_SEED, hnsw_M=GRAPH_M,
                     hnsw_ef_construction=GRAPH_EF_CONSTRUCTION,
                     max_batch=BATCH, compact_every=1_000_000)
    with SecureAnnService() as svc:
        t0 = time.perf_counter()
        svc.create_collection(spec, EncryptedCorpus(C_sap=C_sap, C_dce=C_dce,
                                                    index=index),
                              placement=sharded_placement())
        svc.warmup("t0", spec.name, k=K, ratio_k=RATIO_K,
                   ef_search=EF_SEARCH)
        t_create = time.perf_counter() - t0
        col = svc.collection("t0", spec.name)
        reset_launches()
        ids, lat = run_batches(col, Q, T)
        launches = kernel_launches()
        checks = against_plain(col, Q, T, ids, "sharded graph")
        t0 = time.perf_counter()
        (ppcol,) = svc.save(tmp / "sharded_graph")
        t_save = time.perf_counter() - t0
    free_card()
    events = dict(_build.events)
    t0 = time.perf_counter()
    with SecureAnnService.load(tmp / "sharded_graph") as svc:
        col = svc.collection("t0", spec.name)
        t_load = time.perf_counter() - t0
        ids_l, _ = run_batches(col, Q, T)
        builds = {k: v - events[k] for k, v in _build.events.items()}
    free_card()
    nb = len(lat)
    rec = {"phase": "sharded_path", "step": "e", "path": "sharded_graph",
           "n": C_sap.shape[0], "shards": SHARDS,
           "rows_per_shard": [int(h.size) for h, _ in built],
           "subgraph_build_s": [s for _, s in built],
           "waited_for_subgraphs_s": t_wait, "queries": Q.shape[0],
           **lat_stats(lat),
           "recall@10": synth.recall_at_k(ids, g["ds"].gt, K),
           "checks": checks, "create_and_warmup_s": t_create,
           "launches_per_batch": {k: v / nb for k, v in launches.items()
                                  if v},
           "launches": launches,
           "persistence": {"ppcol_bytes": ppcol.stat().st_size,
                           "save_s": t_save, "load_s": t_load,
                           "ids_equal_after_load": bool((ids_l == ids).all()),
                           "kernel_builds_after_load": builds}}
    log(json.dumps(rec))
    if not checks["ids_equal_plain"]:
        raise AssertionError("sharded graph: kernel ids differ from the "
                             "plain torch walk's")
    if (launches["graph_expand.graph_walk"] != SHARDS * nb
            or launches["dce_comp.refine_topk"] != nb):
        raise AssertionError(f"sharded graph: {launches} for {nb} batches")
    if not rec["persistence"]["ids_equal_after_load"] or any(builds.values()):
        raise AssertionError(f"sharded graph after load: {rec['persistence']}")
    return rec, launches


def sharded_recovery(g: dict, tmp: Path) -> dict:
    """(f, second half) a sharded flat collection over the graph corpus
    with a WAL and an AsyncCheckpointer: a checkpoint of the loaded rows,
    the 1,000 held-out rows in 10 inserts, 100 deletes, then an insert
    that crashes before its fsync (`FaultPlan.crash_before_fsync`), and
    `recover`: the recovered state_digest must equal the acknowledged
    state's and its ids the ids answered before the crash."""
    from repro_torch import resilience as R
    from repro_torch.serving.runtime import Collection
    Q, T, C_sap, C_dce = g["Q"], g["T"], g["C_sap"], g["C_dce"]

    def make():
        return Collection("t0", "wal", C_sap.shape[1], keyless=True,
                          seed=SHARD_SEED, backend="flat", max_batch=BATCH,
                          compact_every=1_000_000,
                          placement=sharded_placement())

    wal_dir, ckpt = tmp / "wal", tmp / "wal.ppcol"
    col = make()
    col.load_snapshot(C_sap, C_dce)
    wal = R.WriteAheadLog(wal_dir)
    R.attach_wal(col, wal)
    cp = R.AsyncCheckpointer(col, ckpt)
    t0 = time.perf_counter()
    cp.checkpoint()
    t_ckpt = time.perf_counter() - t0
    plan = R.FaultPlan().crash_before_fsync(at_record=WAL_BURSTS + 2)
    plan.install(col)
    extra_sap, extra_dce = g["extra_sap"], g["extra_dce"]
    step = extra_sap.shape[0] // WAL_BURSTS
    t0 = time.perf_counter()
    for b in range(WAL_BURSTS):
        col.insert_encrypted(extra_sap[b * step:(b + 1) * step],
                             extra_dce[b * step:(b + 1) * step])
    gone = np.random.default_rng(SHARD_SEED + 5).choice(
        C_sap.shape[0], WAL_DELETES, replace=False)
    col.delete(gone)
    t_ops = time.perf_counter() - t0
    acked = col.store.state_digest()
    want, _ = run_batches(col, Q, T)
    try:
        col.insert_encrypted(g["probe_sap"], g["probe_dce"])
        raise AssertionError("the planned crash did not happen")
    except R.SimulatedCrash:
        pass
    col.close()
    wal.close()
    del col
    free_card()
    t0 = time.perf_counter()
    col2, report = R.recover(make, checkpoint_path=ckpt, wal_dir=wal_dir)
    t_recover = time.perf_counter() - t0
    try:
        digest = col2.store.state_digest()
        t0 = time.perf_counter()
        got, _ = run_batches(col2, Q, T)
        t_first = time.perf_counter() - t0
    finally:
        col2.close()
    del col2
    free_card()
    rec = {"phase": "resilience", "n": C_sap.shape[0], "shards": SHARDS,
           "inserts": int(extra_sap.shape[0]), "insert_records": WAL_BURSTS,
           "deletes": WAL_DELETES, "checkpoint_s": t_ckpt,
           "checkpoint_bytes": ckpt.stat().st_size,
           "mutations_s": t_ops, "recovery_s": t_recover,
           "first_search_after_recovery_s": t_first,
           "report": {"had_checkpoint": report.had_checkpoint,
                      "checkpoint_seq": report.checkpoint_seq,
                      "n_replayed": report.n_replayed,
                      "n_rows_replayed": report.n_rows_replayed,
                      "last_seq": report.last_seq},
           "digest_equal_acked": digest == acked,
           "ids_equal_before_crash": bool((got == want).all()),
           "deleted_ids_returned": deleted_returned(got, gone)}
    log(json.dumps(rec))
    if not (rec["digest_equal_acked"] and rec["ids_equal_before_crash"]
            and report.n_replayed == WAL_BURSTS + 1
            and not rec["deleted_ids_returned"]):
        raise AssertionError(f"recovery: {rec}")
    return rec


def secure_scan(ctx: dict) -> dict:
    """(g) `build_secure_scan_step` over phase 3's 1M rows in 4 shards (K1
    per shard, the merge, K2) against the global step (one K1 over all
    rows, K2; its launches uncounted): candidate and final id sets equal
    in every query."""
    import torch
    from repro_torch.launch.mesh import local_devices
    from repro_torch.serving import secure_scan as ss
    Q, T = ctx["Q"], ctx["T"]
    devices = local_devices()[:SHARDS]
    C_sap = torch.from_numpy(ctx["C_sap"]).to(devices[0])
    C_dce = torch.from_numpy(ctx["C_dce"]).to(devices[0])
    kp = K * RATIO_K
    step = ss.build_secure_scan_step(devices, k=K, k_prime=kp)
    glob = ss.build_secure_scan_step_gspmd(devices, k=K, k_prime=kp)
    Qd = torch.from_numpy(Q).to(devices[0])
    Td = torch.from_numpy(T).to(devices[0])
    step(C_sap, C_dce, Qd[:BATCH], Td[:BATCH])       # warm
    reset_launches()
    lat, same_c, same_i = [], 0, 0
    for s in range(0, Q.shape[0], BATCH):
        t0 = time.perf_counter()
        ids, cand = step(C_sap, C_dce, Qd[s:s + BATCH], Td[s:s + BATCH],
                         with_candidates=True)
        ids, cand = ids.cpu().numpy(), cand.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        with untallied():
            gids, gcand = glob(C_sap, C_dce, Qd[s:s + BATCH],
                               Td[s:s + BATCH], with_candidates=True)
        gids, gcand = gids.cpu().numpy(), gcand.cpu().numpy()
        same_c += sum(set(a) == set(b) for a, b in zip(cand, gcand))
        same_i += sum(set(a) == set(b) for a, b in zip(ids, gids))
    launches = kernel_launches()
    del C_sap, C_dce
    free_card()
    nq, nb = Q.shape[0], len(lat)
    rec = {"phase": "sharded_path", "step": "g", "path": "secure_scan",
           "n": ctx["C_sap"].shape[0], "shards": SHARDS, "queries": nq,
           **lat_stats(lat),
           "candidate_sets_equal": same_c / nq, "id_sets_equal": same_i / nq,
           "launches_per_batch": {k: v / nb for k, v in launches.items()
                                  if v},
           "launches": launches}
    log(json.dumps(rec))
    if same_c != nq or same_i != nq:
        raise AssertionError(f"secure scan: {rec}")
    if (launches["l2_topk.knn"] != SHARDS * nb
            or launches["dce_comp.refine_topk"] != nb):
        raise AssertionError(f"secure scan: {launches} for {nb} batches")
    return launches


def sharded_paths(corpus: dict, graph: dict) -> dict:
    """Phase 8: placement, sharding and resilience on the card, 8
    logical placement devices on the one card.  -> (launches by path,
    the sharded graph's record)."""
    import tempfile
    from repro_torch.launch.mesh import force_device_count
    t0 = time.perf_counter()
    force_device_count(LOGICAL_DEVICES)
    try:
        rec_a, col = sharded_flat(corpus, SHARDS)
        try:
            sharded_failover(col, corpus["Q"], corpus["T"], rec_a["ids"])
        finally:
            col.close()
        del col
        free_card()
        rec_a8, col8 = sharded_flat(corpus, 2 * SHARDS)
        col8.close()
        del col8
        free_card()
        on_int8 = sharded_int8(corpus)
        sharded_vs_single(graph, "ivf", backend="ivf",
                          n_partitions=IVF_PARTITIONS, nprobe=IVF_NPROBE)
        _, on_pq8 = sharded_vs_single(graph, "pq8", backend="flat",
                                      quantization="pq8")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_p8_") as tmp:
            rec_e, on_graph = sharded_graph(graph, Path(tmp))
            sharded_recovery(graph, Path(tmp))
        on_scan = secure_scan(corpus)
    finally:
        force_device_count(None)
    log(json.dumps({"phase": "sharded_done",
                    "wall_s": time.perf_counter() - t0}))
    return {"sharded_flat": rec_a["launches"], "sharded_int8": on_int8,
            "sharded_pq8": on_pq8, "sharded_graph": on_graph,
            "secure_scan": on_scan}, rec_e


# --------------------------------------------------------------- phase 9

LM_ARCH = "qwen3-1.7b"          # src/repro_torch/configs/qwen3_1p7b.py
LM_BATCH, LM_PROMPT, LM_NEW = 4, 32, 16   # the reference serve CLI's
LONG_PROMPT, LONG_T_MAX = 4_080, 4_096    # a prefill on the chunked branch
DECODE_TOL = 2e-2               # rtol = atol of tests/test_arch_smoke.py
BF16_MANTISSA = 7               # bfloat16's stored significand bits
# the kNN-LM loop of examples/rag_serving.py at full width: the
# datastore's rows are d_model wide
KNN_N, KNN_K, KNN_LAM, KNN_STEPS, KNN_PROMPT = 100_000, 8, 0.3, 8, 16
# (e) the other families: (arch, layers built (None: all), the fp32
# check's width)
FAMILY_ARCHS = (("mamba2-370m", None, "full"),
                ("zamba2-1.2b", None, "full"),
                ("whisper-small", None, "full"),
                ("grok-1-314b", 1, "full"),
                ("kimi-k2-1t-a32b", 1, "smoke"))
MOE_CHECK_CF = 8.0              # tests/test_arch_smoke.py: no drops
SSM_LONG_PROMPT, SSM_LONG_STEPS = 4_096, 128   # 32 SSD chunks, then 33
HYBRID_LONG_T_MAX = 4_608       # > 2048, a multiple of 512: chunked prefill


def sync_s(fn):
    """(fn's result, host seconds to its end on the card)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lm_batch(cfg, B: int, S: int, gen) -> dict:
    """A random batch on the card: B x S token ids, and for encdec the
    stub frame embeddings `enc_input` (B, enc_seq_len, d_model)."""
    import torch
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["enc_input"] = torch.randn(
            (B, cfg.enc_seq_len, cfg.d_model), generator=gen,
            device="cuda")
    return batch


def logit_check(got, want) -> tuple[dict, bool]:
    """got against want (..., V) within rtol = atol = DECODE_TOL: the
    largest error, its excess over the tolerance, argmax agreement."""
    import torch
    want = want.float()
    err = (got.float() - want).abs()
    excess = float((err - DECODE_TOL * (1 + want.abs())).max())
    same = got.argmax(-1) == want.argmax(-1)
    return ({"max_abs_err": float(err.max()),
             "max_excess_over_tolerance": excess,
             "argmax_equal": bool(same.all()),
             "argmax_equal_share": float(same.float().mean())},
            excess <= 0 and bool(torch.isfinite(got).all()))


@contextlib.contextmanager
def capacity_factor(model, cf):
    """The model's MoE capacity factor set to cf (None: unchanged) for a
    while; the MoE block reads it from the config at each call."""
    cfg = model.cfg
    if cf is not None:
        model.cfg = dataclasses.replace(cfg, moe_capacity_factor=cf)
    try:
        yield
    finally:
        model.cfg = cfg


def lm_decode_check(model, B: int, S: int, t_max: int, gen) -> dict:
    """decode_step(prefill(prompt)) against forward(prompt + token), the
    reference test's check (rtol = atol = 2e-2) at full width: the
    prefill's logits against forward's at the prompt's last position,
    the decode step's against forward's at the token's."""
    from repro_torch.models import layers as L
    cfg = model.cfg
    batch = lm_batch(cfg, B, S + 1, gen)
    tokens = batch["tokens"]
    full, forward_s = sync_s(lambda: model.forward(batch))
    cache = model.init_cache(B, t_max)
    (pre, cache), prefill_s = sync_s(
        lambda: model.prefill(dict(batch, tokens=tokens[:, :-1]), cache))
    (dec, cache), decode_s = sync_s(
        lambda: model.decode_step(tokens[:, -1:], cache))
    checks, ok = {}, True
    for name, got, want in (("prefill", pre, full[:, -2]),
                            ("decode", dec, full[:, -1])):
        checks[name], good = logit_check(got, want)
        ok &= good
    rec = {"phase": "lm", "step": "a", "check": "prefill_decode_vs_forward",
           "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "batch": B, "prompt": S,
           "moe_capacity_factor": (cfg.moe_capacity_factor
                                   if cfg.family == "moe" else None),
           "t_max": t_max, "rtol": DECODE_TOL, "atol": DECODE_TOL,
           "prefill_chunked_attention": (
               S > 1 and t_max > L.FLASH_THRESHOLD
               and t_max % L.FLASH_KV_CHUNK == 0),
           "forward_s": forward_s, "prefill_s": prefill_s,
           "decode_s": decode_s, **checks}
    del full, pre, dec, cache
    if not ok:
        raise AssertionError(f"prefill/decode differ from forward at "
                             f"B={B} S={S}: {checks}")
    return rec


def decode_step_bytes(model, cache) -> dict:
    """Bytes one decode step at the cache's pos must move: the weights
    the decoder reads (all but the encoder's; every expert's, as the MoE
    block reads them all), the KV rows [0, pos] of each self-attention
    cache, the cross K/V whole, and the conv and float32 SSM states read
    and written."""
    pos = int(cache["pos"])
    out = {"weights": sum(p.numel() * p.element_size()
                          for n, p in model.named_parameters()
                          if not n.startswith("encoder.")),
           "kv_rows": 0, "cross_kv": 0, "ssm_state_read_written": 0}
    for name, t in cache.items():
        if name == "pos":
            continue
        nbytes = t.numel() * t.element_size()
        if name in ("k", "v", "ak", "av"):
            out["kv_rows"] += nbytes * (pos + 1) // t.shape[2]
        elif name in ("xk", "xv"):
            out["cross_kv"] += nbytes
        else:                                       # conv, state
            out["ssm_state_read_written"] += 2 * nbytes
    out["total"] = sum(out.values())
    return out


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a nested dict (a host int counts none)."""
    import torch
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.nbytes if isinstance(tree, torch.Tensor) else 0


def decode_step_memory(model, token, cache) -> dict:
    """One decode step's arguments on the card (the weights, the cache,
    the token) and the max_memory_allocated increment over the step:
    their sum is the step's measured peak, which phase 11 (a) holds the
    dry run's against."""
    import torch
    args = (tensor_bytes(dict(model.named_parameters()))
            + tensor_bytes(cache) + token.nbytes)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.decode_step(token, cache)
    torch.cuda.synchronize()
    incr = torch.cuda.max_memory_allocated() - base
    return {"decode_step_argument_bytes": args,
            "decode_step_peak_increment_bytes": incr,
            "decode_step_peak_bytes": args + incr}


def lm_generate(fp32, bf16, gen, card: str) -> dict:
    """`LMServer.generate` in bf16 at the reference CLI's batch, prompt
    and new tokens: times, greedy agreement with the fp32 model's
    tokens (fp32=None: none to compare), and the first token against
    bf16 forward's argmax wherever the top-2 margin is resolved (above
    two bf16 ulps of the top logit and twice the largest gap between the
    prefill's and forward's logits, the two bf16 computations of the
    same function)."""
    import torch
    from repro_torch.serving import LMServer
    from repro_torch.serving.engine import greedy
    cfg = bf16.cfg
    batch = lm_batch(cfg, LM_BATCH, LM_PROMPT, gen)
    server = LMServer(bf16)
    server.generate(batch, 2)                      # warm-up
    out, gen_s = sync_s(lambda: server.generate(batch, LM_NEW))
    out32 = (None if fp32 is None
             else LMServer(fp32).generate(batch, LM_NEW))
    t_max = LM_PROMPT + LM_NEW
    prefill_ms = host_ms(lambda: bf16.prefill(
        batch, bf16.init_cache(LM_BATCH, t_max)))
    cache = bf16.init_cache(LM_BATCH, t_max)
    logits, cache = bf16.prefill(batch, cache)
    step_ms = []
    for i in range(LM_NEW - 1):
        (logits, cache), s = sync_s(
            lambda: bf16.decode_step(out[:, i:i + 1], cache))
        step_ms.append(s * 1e3)
    at = dict(cache, pos=LM_PROMPT)                # rewrites one row
    step_bytes = decode_step_bytes(bf16, at)
    step_memory = decode_step_memory(bf16, out[:, :1], at)
    prof = profile_steps(lambda i: bf16.decode_step(out[:, :1], at), 4,
                         unit="step")

    full = bf16.forward(batch)[:, -1].float()
    pre, _ = bf16.prefill(batch, bf16.init_cache(LM_BATCH, t_max))
    top2 = full.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs()))
                     - BF16_MANTISSA)
    gap = (pre.float() - full).abs().amax(-1)
    resolved = margin > 2 * torch.maximum(ulp, gap)
    first_ok = (out[:, 0] == greedy(full)) | ~resolved
    same32 = None if out32 is None else (out == out32).float()
    rec = {"phase": "lm", "step": "a", "check": "generate", "card": card,
           "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": LM_BATCH,
           "prompt": LM_PROMPT, "new_tokens": LM_NEW,
           "generate_s": gen_s, "tokens_per_s": LM_BATCH * LM_NEW / gen_s,
           "prefill_ms": prefill_ms,
           "decode_ms_per_step_median": statistics.median(step_ms),
           "decode_ms_per_step": step_ms,
           "decode_bound_ms": step_bytes["total"] / PEAK_BYTES_PER_S * 1e3,
           "decode_bound_by": "bytes over 3.35 TB/s",
           "decode_step_bytes": step_bytes, **step_memory,
           "decode_profile": prof,
           "greedy_equal_fp32_share": (None if same32 is None
                                       else float(same32.mean())),
           "greedy_equal_fp32_by_step": (None if same32 is None
                                         else same32.mean(0).tolist()),
           "first_token_margin": margin.tolist(),
           "first_token_ulp": ulp.tolist(),
           "first_token_prefill_forward_gap": gap.tolist(),
           "first_token_resolved": resolved.tolist(),
           "first_token_equal_forward_argmax": (
               out[:, 0] == greedy(full)).tolist()}
    if cfg.family == "moe":
        # what a token's top-k experts alone would read: the bound of a
        # dispatch that skips the experts no token was routed to
        active = bf16.n_active_params() * bf16.embed["tokens"].element_size()
        rec |= {"n_params": bf16.n_params(),
                "n_active_params": bf16.n_active_params(),
                "moe_capacity_factor": cfg.moe_capacity_factor,
                "active_weight_bytes": active,
                "decode_bound_active_ms": (
                    step_bytes["total"] - step_bytes["weights"] + active)
                / PEAK_BYTES_PER_S * 1e3}
    if out.shape != (LM_BATCH, LM_NEW) or not bool(first_ok.all()):
        raise AssertionError(f"bf16 generate: shape {tuple(out.shape)}, "
                             f"first tokens {rec}")
    return rec


def lm_long_check(model, gen, t_max: int) -> dict:
    """The long_500k families at B 1, in two parts: prefill
    SSM_LONG_PROMPT tokens against forward over them at the last
    position, then SSM_LONG_STEPS decode steps against forward over all
    the tokens, position by position, within rtol = atol = DECODE_TOL."""
    import torch
    from repro_torch.models import layers as L
    cfg = model.cfg
    P, N = SSM_LONG_PROMPT, SSM_LONG_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (1, P + N), generator=gen,
                           device="cuda", dtype=torch.int32)
    want_pre, forward_prompt_s = sync_s(
        lambda: model.forward({"tokens": tokens[:, :P]})[:, -1])
    cache = model.init_cache(1, t_max)
    (pre, cache), prefill_s = sync_s(
        lambda: model.prefill({"tokens": tokens[:, :P]}, cache))
    full, forward_s = sync_s(
        lambda: model.forward({"tokens": tokens})[:, P:])
    dec, step_s = [], []
    for i in range(N):
        (logits, cache), s = sync_s(
            lambda: model.decode_step(tokens[:, P + i:P + i + 1], cache))
        dec.append(logits)
        step_s.append(s)
    dec = torch.stack(dec, 1)                               # (1, N, V)
    checks = {}
    checks["prefill"], ok_pre = logit_check(pre, want_pre)
    checks["decode"], ok_dec = logit_check(dec, full)
    err_by_pos = (dec.float() - full.float()).abs().amax(-1)[0]
    checks["decode"]["max_abs_err_last_step"] = float(err_by_pos[-1])
    rec = {"phase": "lm", "step": "e", "check": "long_prefill_decode_vs_"
           "forward", "arch": cfg.name, "layers": cfg.n_layers,
           "dtype": cfg.dtype, "batch": 1, "prompt": P, "decode_steps": N,
           "t_max": t_max, "ssd_chunks_prefill": P // 128,
           "ssd_chunks_forward": (P + N) // 128,
           "rtol": DECODE_TOL, "atol": DECODE_TOL,
           "prefill_chunked_attention": (
               cfg.family == "hybrid" and t_max > L.FLASH_THRESHOLD
               and t_max % L.FLASH_KV_CHUNK == 0),
           "forward_prompt_s": forward_prompt_s, "prefill_s": prefill_s,
           "forward_s": forward_s,
           "decode_ms_per_step_median": statistics.median(step_s) * 1e3,
           **checks}
    del want_pre, pre, full, dec, cache
    if not (ok_pre and ok_dec):
        raise AssertionError(f"long prefill/decode differ from forward: "
                             f"{checks}")
    return rec


def knn_lm_loop(model, svc, user, store_tok, prompt) -> dict:
    """examples/rag_serving.py's decode loop on the card: each step's
    probe (the embedding row of the argmax token) goes to the keyless
    service as one batch request, and the retrieved rows' next tokens
    are blended into the logits.  -> ids (steps, B, k), tokens
    (B, steps), probes (steps, B, d), and host ms a step of the user's
    encryption, the service's answer and the LM's decode step."""
    import torch
    from repro_torch.api import SearchParams
    from repro_torch.serving.engine import greedy
    B = prompt.shape[0]
    cache = model.init_cache(B, KNN_PROMPT + KNN_STEPS)
    logits, cache = model.prefill({"tokens": prompt}, cache)
    tok_dev = torch.as_tensor(store_tok, device="cuda", dtype=torch.long)
    run = {"ids": [], "tokens": [], "probes": [], "user_ms": [],
           "service_ms": [], "lm_ms": []}
    for _ in range(KNN_STEPS):
        t0 = time.perf_counter()
        probe = model.embed["tokens"][greedy(logits)].float().cpu().numpy()
        req = user.request("lm", "datastore", probe,
                           SearchParams(k=KNN_K))
        t1 = time.perf_counter()
        nbr = svc.submit(req).ids                          # (B, k)
        t2 = time.perf_counter()
        knn_logits = torch.full(logits.shape, -1e30, device="cuda")
        knn_logits.scatter_(1, tok_dev[torch.as_tensor(nbr, device="cuda")],
                            0.0)
        nxt = greedy((1 - KNN_LAM) * logits.float()
                     + KNN_LAM * knn_logits).to(torch.int32)[:, None]
        logits, cache = model.decode_step(nxt, cache)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        run["ids"].append(nbr)
        run["tokens"].append(nxt[:, 0].cpu().numpy())
        run["probes"].append(probe)
        run["user_ms"].append((t1 - t0) * 1e3)
        run["service_ms"].append((t2 - t1) * 1e3)
        run["lm_ms"].append((t3 - t2) * 1e3)
    return {k: (np.stack(v, 1) if k == "tokens" else
                np.stack(v) if k in ("ids", "probes") else v)
            for k, v in run.items()}


def knn_lm(model, gen, card: str) -> tuple[dict, dict]:
    """(b) The kNN-LM loop at full width through the port's API: a flat
    collection of KNN_N encrypted d_model-wide rows in a keyless service,
    decoded once through the kernels and once with them swapped for
    their plain versions.  -> (record, launches)."""
    import torch
    from repro_torch.api import DataOwnerClient, IndexSpec, SecureAnnService
    cfg = model.cfg
    d = cfg.d_model
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    store_emb = rng.standard_normal((KNN_N, d), dtype=np.float32)
    store_tok = rng.integers(0, cfg.vocab_size, KNN_N).astype(np.int32)
    t_data = time.perf_counter() - t0
    spec = IndexSpec(tenant="lm", name="datastore", d=d, backend="flat",
                     sap_beta=1.0, seed=1)
    t0 = time.perf_counter()
    owner = DataOwnerClient(spec)              # keys stay with the owner
    t_keygen = time.perf_counter() - t0
    t0 = time.perf_counter()
    C_sap, C_dce = owner.encrypt_vectors(store_emb)        # on the card
    t_encrypt = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, KNN_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    with SecureAnnService() as svc:
        svc.create_collection(spec)
        t0 = time.perf_counter()
        svc.insert("lm", "datastore", C_sap, C_dce)
        t_insert = time.perf_counter() - t0
        dce_bytes, sap_bytes = C_dce.nbytes, C_sap.nbytes
        del C_sap, C_dce
        t0 = time.perf_counter()
        svc.warmup("lm", "datastore", k=KNN_K)
        t_warmup = time.perf_counter() - t0
        reset_launches()
        run = knn_lm_loop(model, svc, owner.query_client(seed=9),
                          store_tok, prompt)
        launches = kernel_launches()
        reset_launches()
        with plain_kernels():
            plain = knn_lm_loop(model, svc, owner.query_client(seed=9),
                                store_tok, prompt)
        plain_launches = sum(kernel_launches().values())
    # plaintext exact kNN of the probes the kernel run sent
    X = torch.as_tensor(store_emb, device="cuda")
    P = torch.as_tensor(run["probes"].reshape(-1, d), device="cuda")
    exact = torch.topk((X * X).sum(1)[None] - 2.0 * P @ X.T, KNN_K, dim=1,
                       largest=False).indices.cpu().numpy()
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in
               zip(run["ids"].reshape(-1, KNN_K), exact))
    del X, P
    same_ids = run["ids"] == plain["ids"]                # (steps, B, k)
    agree = float(same_ids.mean())
    rows_same = same_ids.all(-1).T                       # (B, steps)
    tokens_ok = bool((run["tokens"] == plain["tokens"])[rows_same].all())
    k1, k2 = launches["l2_topk.knn"], launches["dce_comp.refine_topk"]
    rec = {"phase": "lm", "step": "b", "path": "knn_lm", "card": card,
           "arch": cfg.name, "dtype": cfg.dtype, "n": KNN_N, "d": d,
           "D": 2 * (d + d % 2) + 16, "batch": LM_BATCH, "k": KNN_K,
           "k_prime": KNN_K * RATIO_K, "lam": KNN_LAM, "steps": KNN_STEPS,
           "dce_bytes": dce_bytes, "sap_bytes": sap_bytes,
           "datastore_s": t_data, "keygen_s": t_keygen,
           "encrypt_s": t_encrypt, "insert_s": t_insert,
           "warmup_s": t_warmup,
           "user_encrypt_ms_per_step": statistics.median(run["user_ms"]),
           "retrieval_ms_per_step": statistics.median(run["service_ms"]),
           "retrieval_ms_per_step_plain":
               statistics.median(plain["service_ms"]),
           "lm_decode_ms_per_step": statistics.median(run["lm_ms"]),
           "recall@8_vs_plaintext": hits / (KNN_STEPS * LM_BATCH * KNN_K),
           "id_agreement_plain": agree,
           "tokens_equal_where_ids_equal": tokens_ok,
           "launches": {"l2_topk.knn": k1, "dce_comp.refine_topk": k2},
           "plain_run_launches": plain_launches}
    if (agree < MIN_ID_AGREEMENT or not tokens_ok or k1 != KNN_STEPS
            or k2 != KNN_STEPS or plain_launches):
        raise AssertionError(f"kNN-LM: {rec}")
    return rec, launches


def lm_serve_main(argv=("--secure-ann",)) -> tuple[dict, dict]:
    """(d) The port's serve entry point on the card at the reference
    CLI's defaults (smoke width, 5,000 encrypted vectors); (e) the same
    with `--arch`.  -> (record, launches)."""
    import io
    from repro_torch.launch import serve
    argv = list(argv)
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = serve.main(argv)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log("  " + line)
    recall = [float(line.split("recall@10=")[1].split()[0])
              for line in lines if "recall@10=" in line]
    rec = {"phase": "lm", "step": "e" if "--arch" in argv else "d",
           "path": "lm_serve", "argv": argv, "tokens_shape": list(out.shape),
           "tokens_device": out.device.type, "recall@10": recall,
           "wall_s": wall, "launches": {
               k: v for k, v in launches.items() if v}}
    if (tuple(out.shape) != (4, 16) or out.device.type != "cuda"
            or len(recall) != 1 or not launches["l2_topk.knn"]
            or not launches["dce_comp.refine_topk"]):
        raise AssertionError(f"serve --secure-ann: {rec}")
    return rec, launches


def log_card_memory(what: str) -> None:
    import torch
    free, total = torch.cuda.mem_get_info()
    log(json.dumps({"phase": "lm", "step": "e", "memory_before": what,
                    "free_bytes": free, "total_bytes": total,
                    "allocated_bytes": torch.cuda.memory_allocated()}))


def family_paths(card: str) -> dict:
    """Phase 9 (e): the ssm, hybrid, encdec and moe families on the card,
    one model at a time.  -> launches of the serve runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(10)
    for arch, n_layers, fp32_width in FAMILY_ARCHS:
        full_cfg = get_config(arch)
        cfg = dataclasses.replace(full_cfg,
                                  n_layers=n_layers or full_cfg.n_layers)
        moe = cfg.family == "moe"
        log_card_memory(f"{arch} fp32 ({fp32_width} width)")
        fp32, init_s = sync_s(lambda: Model(
            cfg if fp32_width == "full" else cfg.smoke(), device="cuda",
            dtype=torch.float32, seed=0))
        log(json.dumps({
            "phase": "lm", "step": "e", "init": "fp32", "card": card,
            "arch": arch, "width": fp32_width,
            "layers": fp32.cfg.n_layers, "layers_of": full_cfg.n_layers,
            "enc_layers": fp32.cfg.n_enc_layers,
            "d_model": fp32.cfg.d_model, "vocab": fp32.cfg.vocab_size,
            "n_params": fp32.n_params(),
            "n_params_metas": fp32.n_meta_params(),
            "n_active_params": fp32.n_active_params(),
            "fp32_bytes": 4 * fp32.n_params(), "init_s": init_s}))
        if fp32.n_params() != fp32.n_meta_params():
            raise AssertionError(f"{arch}: the model holds another count "
                                 "of parameters than its metas")
        with capacity_factor(fp32, MOE_CHECK_CF if moe else None):
            rec = lm_decode_check(fp32, LM_BATCH, LM_PROMPT,
                                  LM_PROMPT + 1, gen)
        log(json.dumps(dict(rec, step="e", card=card)))
        if cfg.family in ("ssm", "hybrid"):
            t_max = (HYBRID_LONG_T_MAX if cfg.family == "hybrid"
                     else SSM_LONG_PROMPT + SSM_LONG_STEPS)
            log(json.dumps(dict(lm_long_check(fp32, gen, t_max),
                                card=card)))
        free_card()
        if fp32_width == "full":
            bf16 = Model(cfg, device="cuda", dtype=torch.bfloat16,
                         seed=None)
            bf16.load_state_dict(fp32.state_dict())
        else:
            del fp32
            fp32 = None
            free_card()
            log_card_memory(f"{arch} bf16")
            bf16, init_s = sync_s(lambda: Model(
                cfg, device="cuda", dtype=torch.bfloat16, seed=0))
            log(json.dumps({
                "phase": "lm", "step": "e", "init": "bf16", "card": card,
                "arch": arch, "layers": cfg.n_layers,
                "layers_of": full_cfg.n_layers, "n_params": bf16.n_params(),
                "n_active_params": bf16.n_active_params(),
                "bf16_bytes": 2 * bf16.n_params(), "init_s": init_s}))
        log(json.dumps(dict(lm_generate(fp32, bf16, gen, card), step="e")))
        del fp32, bf16
        free_card()
    on_serve: dict = {}
    for arch, _, _ in FAMILY_ARCHS:
        rec, launches = lm_serve_main(["--arch", arch, "--secure-ann"])
        log(json.dumps(dict(rec, card=card)))
        for k, v in launches.items():
            on_serve[k] = on_serve.get(k, 0) + v
        free_card()
    log(json.dumps({"phase": "lm_families_done", "card": card,
                    "wall_s": time.perf_counter() - t_start}))
    return on_serve


def lm_paths(card: str) -> tuple[dict, dict]:
    """Phase 9: the LM server and its encrypted kNN-LM retrieval on the
    card.  -> (launches by path, (a)'s bf16 `generate` record)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    t_start = time.perf_counter()
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(9)
    fp32, init_s = sync_s(lambda: Model(cfg, device="cuda",
                                        dtype=torch.float32, seed=0))
    log(json.dumps({"phase": "lm", "step": "init", "card": card,
                    "arch": cfg.name,
                    "layers": cfg.n_layers, "d_model": cfg.d_model,
                    "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                    "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                    "n_params": fp32.n_params(),
                    "n_params_metas": fp32.n_meta_params(),
                    "fp32_bytes": 4 * fp32.n_params(), "init_s": init_s}))
    if fp32.n_params() != fp32.n_meta_params():
        raise AssertionError("the model holds another count of "
                             "parameters than its metas")
    log(json.dumps(dict(lm_decode_check(fp32, LM_BATCH, LM_PROMPT,
                                        LM_PROMPT + 1, gen), card=card)))
    log(json.dumps(dict(lm_decode_check(fp32, 1, LONG_PROMPT, LONG_T_MAX,
                                        gen), card=card)))
    free_card()
    bf16 = Model(cfg, device="cuda", dtype=torch.bfloat16, seed=None)
    bf16.load_state_dict(fp32.state_dict())
    rec_a = lm_generate(fp32, bf16, gen, card)
    log(json.dumps(rec_a))
    del fp32
    free_card()
    rec_b, on_knn = knn_lm(bf16, gen, card)
    log(json.dumps(rec_b))
    del bf16
    free_card()
    rec_d, on_serve = lm_serve_main()
    log(json.dumps(dict(rec_d, card=card)))
    free_card()
    on_families = family_paths(card)
    log(json.dumps({"phase": "lm_done", "card": card,
                    "wall_s": time.perf_counter() - t_start}))
    return {"knn_lm": on_knn, "lm_serve": {
        k: on_serve[k] + on_families.get(k, 0) for k in on_serve}}, rec_a


# -------------------------------------------------------------- phase 10

TRAIN_ARCH = "qwen3-1.7b"       # src/repro_torch/configs/qwen3_1p7b.py
TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 256      # (a) remat on against off
MICRO_B, MICRO_N = 4, 4                    # (a) 4 microbatches of 1 row
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 20  # (c)
TRAIN_SAVE_AT = 10                          # (d)
TRAIN_LR, TRAIN_WARMUP = 1e-3, 5
REMAT_RTOL = 1e-5               # per leaf, of max|g|
MICRO_LOSS_RTOL = 1e-4          # tests/test_training.py:84's bars
MICRO_WEIGHT_ATOL = 5e-3
# the bars the CPU tests hold the port to against jax.grad
# (tests/test_torch_train_parity.py)
GRAD_RTOL, GRAD_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-5
RING_DEVICES = 4


def on_card(batch: dict) -> dict:
    import torch
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def grad_gap(got: dict, want: dict) -> tuple[float, bool]:
    """(max over leaves of max|got - want| / max|want|, every leaf
    bit-equal)."""
    import torch
    worst, equal = 0.0, True
    for k, w in want.items():
        g = got[k].to(w.device)
        equal = equal and torch.equal(g, w)
        d = float((g.float() - w.float()).abs().max())
        worst = max(worst, d / max(float(w.float().abs().max()), 1e-30))
    return worst, equal


def train_fp32_checks(card: str) -> None:
    """Phase 10 (a): qwen3-1.7b in fp32 at full width and depth: loss
    and gradients with remat on against off (B 2 x S 256), and 4
    microbatches against 1 (B 4 x S 256: axis 0 must split in 4), one
    adamw step each from the same state."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.loader import TokenStream
    from repro_torch.models import Model
    from repro_torch.training import (OptConfig, build_train_step,
                                      init_train_state)
    from repro_torch.training.train_loop import loss_and_grads
    cfg = get_config(TRAIN_ARCH)
    model, init_s = sync_s(lambda: Model(cfg, device="cuda",
                                         dtype=torch.float32, seed=0))
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                    weight_decay=0.0)          # tests/test_training.py's
    state = init_train_state(model, opt)
    batch = on_card(TokenStream(vocab_size=cfg.vocab_size,
                                seq_len=TRAIN_CHECK_S,
                                batch_size=TRAIN_CHECK_B, seed=1).next())
    torch.cuda.reset_peak_memory_stats()
    (loss_on, g_on), s_on = sync_s(
        lambda: loss_and_grads(model, state["params"], batch))
    peak_on = torch.cuda.max_memory_allocated()
    model.cfg = dataclasses.replace(model.cfg, remat=False)
    torch.cuda.reset_peak_memory_stats()
    (loss_off, g_off), s_off = sync_s(
        lambda: loss_and_grads(model, state["params"], batch))
    peak_off = torch.cuda.max_memory_allocated()
    model.cfg = dataclasses.replace(model.cfg, remat=True)
    gap, equal = grad_gap(g_on, g_off)
    del g_on, g_off
    free_card()
    rec = {"phase": "train", "step": "a_remat", "card": card,
           "arch": cfg.name, "dtype": "float32", "batch": TRAIN_CHECK_B,
           "seq": TRAIN_CHECK_S, "n_params": model.n_params(),
           "init_s": init_s, "loss_remat": float(loss_on),
           "loss_no_remat": float(loss_off),
           "grad_max_rel_to_max_abs": gap, "grads_bit_equal": equal,
           "loss_bit_equal": bool(torch.equal(loss_on, loss_off)),
           "s_remat": s_on, "s_no_remat": s_off,
           "peak_bytes_remat": peak_on, "peak_bytes_no_remat": peak_off,
           "tolerance": f"{REMAT_RTOL} * max|g| per leaf"}
    log(json.dumps(rec))
    if gap > REMAT_RTOL or not abs(float(loss_on) - float(loss_off)) <= \
            REMAT_RTOL * abs(float(loss_off)):
        raise AssertionError(f"remat changed the numbers: {rec}")

    batch = on_card(TokenStream(vocab_size=cfg.vocab_size,
                                seq_len=TRAIN_CHECK_S, batch_size=MICRO_B,
                                seed=2).next())
    (s1, m1), t1 = sync_s(lambda: build_train_step(model, opt)(state, batch))
    w1 = {k: v.cpu() for k, v in s1["params"].items()}
    del s1
    free_card()
    (s4, m4), t4 = sync_s(lambda: build_train_step(
        model, opt, n_microbatches=MICRO_N)(state, batch))
    dw = max(float((s4["params"][k].cpu() - w).abs().max())
             for k, w in w1.items())
    rec = {"phase": "train", "step": "a_microbatch", "card": card,
           "batch": MICRO_B, "seq": TRAIN_CHECK_S, "n_microbatches": MICRO_N,
           "loss_1": float(m1["loss"]), "loss_4": float(m4["loss"]),
           "grad_norm_1": float(m1["grad_norm"]),
           "grad_norm_4": float(m4["grad_norm"]),
           "weights_max_abs_diff": dw, "step_s_1": t1, "step_s_4": t4,
           "tolerance": {"loss_rtol": MICRO_LOSS_RTOL,
                         "weights_atol": MICRO_WEIGHT_ATOL}}
    log(json.dumps(rec))
    if (abs(rec["loss_1"] - rec["loss_4"]) > MICRO_LOSS_RTOL
            * abs(rec["loss_1"]) or dw > MICRO_WEIGHT_ATOL):
        raise AssertionError(f"4 microbatches differ from 1: {rec}")


def train_card_vs_host(card: str) -> None:
    """Phase 10 (b): every arch at smoke width, loss and gradients of the
    port on the card against the port on the host (fp32, TF32 off)."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import Model
    from repro_torch.models.convert import stack_params
    from repro_torch.training.train_loop import loss_and_grads
    out = {}
    for arch in ARCHS:
        host = Model(get_config(arch).smoke(), device="cpu",
                     dtype=torch.float32, seed=0)
        dev = Model(host.cfg, device="cuda", seed=None)
        dev.load_state_dict(host.state_dict())
        cfg = host.cfg
        rng = np.random.default_rng(0)
        s_text = 64 - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
        tok = rng.integers(0, cfg.vocab_size, (2, s_text)).astype(np.int32)
        batch = {"tokens": tok, "labels": tok}
        if cfg.family == "vlm":
            batch["vision"] = rng.standard_normal(
                (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            batch["enc_input"] = rng.standard_normal(
                (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
        got = {}
        for name, m in (("cpu", host), ("cuda", dev)):
            params = stack_params(cfg, {k: p.detach()
                                        for k, p in m.named_parameters()})
            got[name] = loss_and_grads(
                m, params, {k: torch.as_tensor(v, device=m.device)
                            for k, v in batch.items()})
        (lh, gh), (lc, gc_) = got["cpu"], got["cuda"]
        worst = 0.0
        for k, w in gh.items():
            d = float((gc_[k].cpu() - w).abs().max())
            tol = GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL
            worst = max(worst, d / tol)
        rel = abs(float(lc) - float(lh)) / abs(float(lh))
        out[arch] = {"loss_host": float(lh), "loss_card": float(lc),
                     "loss_rel": rel, "grad_err_over_tol": worst}
        if rel > LOSS_RTOL or worst > 1.0:
            raise AssertionError(f"{arch}: card against host {out[arch]}")
        del host, dev, got
    log(json.dumps({"phase": "train", "step": "b_card_vs_host",
                    "card": card, "width": "smoke", "archs": out,
                    "tolerance": {"loss_rtol": LOSS_RTOL,
                                  "grads": f"{GRAD_RTOL} * max|g| + "
                                           f"{GRAD_ATOL} per leaf"}}))
    free_card()


def train_step_flops(model, B: int, S: int) -> dict:
    """Model FLOPs of one train step with remat: 6 N T for the weights'
    products (forward 2 N T, backward 4 N T; the tied embedding counted
    once, as the unembedding's product), the attention's two S x S
    products of every layer (4 B H S^2 dh forward, as the port computes
    them: the whole square, masked), 3x for forward and backward, plus
    remat's second forward of the layers (2 N_layers T + the attention's
    forward)."""
    cfg = model.cfg
    n = model.n_params()
    n_layers = sum(p.numel() for k, p in model.named_parameters()
                   if k.startswith("layers."))
    T = B * S
    attn = 4 * B * cfg.n_heads * S * S * cfg.head_dim * cfg.n_layers
    out = {"n_params": n, "n_layer_params": n_layers, "tokens": T,
           "flops_6NT": 6 * n * T, "flops_attention": 3 * attn,
           "flops_remat": 2 * n_layers * T + attn}
    out["flops"] = (out["flops_6NT"] + out["flops_attention"]
                    + out["flops_remat"])
    return out


def train_step_split(model, opt, state, batch, reps: int = 3) -> dict:
    """Device ms (CUDA events, median of reps) of a step's two halves:
    the forward and backward (`loss_and_grads`), and the clip with the
    optimizer update; each rep's outputs are freed before the next."""
    import torch
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.train_loop import loss_and_grads
    upd = opt_mod.make_optimizer(opt)
    grads = None

    def fwd_bwd():
        nonlocal grads
        grads = None
        grads = loss_and_grads(model, state["params"], batch)[1]

    def update():
        g, _ = opt_mod.clip_by_global_norm(grads, opt.grad_clip)
        upd.update(g, state["opt"], state["params"], state["step"])

    out = {}
    for name, fn in (("fwd_bwd_device_ms", fwd_bwd),
                     ("clip_update_device_ms", update)):
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        out[name] = statistics.median(ms)
    return out


def train_run(card: str, tmp: Path) -> dict:
    """Phase 10 (c) and (d): qwen3-1.7b in bf16 at full width and depth,
    adamw with fp32 moments, B 8 x S 512, 20 steps on the Markov corpus,
    a checkpoint at step 10 restored into a fresh state whose step 11
    must equal the uninterrupted run's bit for bit.  -> (c)'s record."""
    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.loader import TokenStream
    from repro_torch.models import Model
    from repro_torch.training import (OptConfig, build_train_step,
                                      init_train_state)
    from repro_torch.training.train_loop import (abstract_train_state,
                                                 state_from_tree, state_tree)
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model, init_s = sync_s(lambda: Model(cfg, device="cuda",
                                         dtype=torch.bfloat16, seed=0))
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                    total_steps=TRAIN_STEPS)
    state = init_train_state(model, opt)
    step_fn = build_train_step(model, opt)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                         batch_size=TRAIN_B, seed=0, markov_temp=0.3)
    batches = [stream.next() for _ in range(TRAIN_STEPS)]
    losses, step_ms = [], []
    for i, b in enumerate(batches):
        if i == TRAIN_SAVE_AT:
            tmp.mkdir(parents=True, exist_ok=True)
            free = shutil.disk_usage(tmp).free
            _, save_s = sync_s(lambda: save_checkpoint(
                str(tmp), i, state_tree(state), extra={"arch": cfg.name}))
        b = on_card(b)
        if i == 0:
            # step 0's arguments and its max_memory_allocated increment:
            # the measured peak phase 11 (a) holds the dry run's against
            step0 = {"step0_argument_bytes": tensor_bytes(state)
                     + tensor_bytes(b)}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            pre_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        loss = float(m["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            incr = torch.cuda.max_memory_allocated() - base
            step0 |= {"step0_peak_increment_bytes": incr,
                      "step0_peak_bytes": step0["step0_argument_bytes"]
                      + incr}
        losses.append(loss)
        if i == TRAIN_SAVE_AT:
            after, loss_after = state["params"], m["loss"]
    peak = max(pre_peak, torch.cuda.max_memory_allocated())
    batch = on_card(batches[-1])
    prof = profile_steps(lambda i: step_fn(state, batch), 1, unit="step")
    split = train_step_split(model, opt, state, batch)
    p50 = statistics.median(step_ms[2:])
    fl = train_step_flops(model, TRAIN_B, TRAIN_S)
    bound_ms = fl["flops"] / PEAK_BF16_FLOPS * 1e3
    n = fl["n_params"]
    opt_bytes = n * (2 + 2 + 4 + 4) + n * (2 + 4 + 4)   # read p g m v, write
    rec = {"phase": "train", "step": "c_bf16_run", "card": card,
           "arch": cfg.name, "dtype": "bfloat16", "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
           "optimizer": "adamw", "moments": "float32", "lr": TRAIN_LR,
           "warmup_steps": TRAIN_WARMUP, "remat": cfg.remat,
           "init_s": init_s, "losses": losses,
           "loss_first5_mean": statistics.mean(losses[:5]),
           "loss_last5_mean": statistics.mean(losses[-5:]),
           "step_ms": step_ms, "step_ms_p50": p50,
           "tokens_per_s": TRAIN_B * TRAIN_S / p50 * 1e3,
           "peak_allocated_bytes": peak, **step0, **fl,
           "bound_ms": bound_ms, "bound_by": "operations (bf16 peak)",
           "optimizer_bytes_bound_ms": opt_bytes / PEAK_BYTES_PER_S * 1e3,
           "share_of_bound": bound_ms / p50, **split, **prof}
    log(json.dumps(rec))
    if not (all(map(math.isfinite, losses))
            and rec["loss_last5_mean"] < rec["loss_first5_mean"]):
        raise AssertionError(f"bf16 training did not learn: {losses}")

    # (d) the checkpoint of step 10, restored into a fresh state
    del state, m
    free_card()
    tree, manifest = restore_checkpoint(
        str(tmp), state_tree(abstract_train_state(model, opt)),
        step=TRAIN_SAVE_AT, device="cuda")
    fresh = state_from_tree(tree)
    del tree
    state, m = step_fn(fresh, on_card(batches[TRAIN_SAVE_AT]))
    equal = all(torch.equal(state["params"][k], w) for k, w in after.items())
    ckpt_bytes = sum(f.stat().st_size
                     for f in (tmp / f"step_{TRAIN_SAVE_AT:08d}").iterdir())
    rec_c = rec
    rec = {"phase": "train", "step": "d_checkpoint", "card": card,
           "saved_at_step": TRAIN_SAVE_AT, "entries": len(manifest["entries"]),
           "checkpoint_bytes": ckpt_bytes, "disk_free_bytes": free,
           "save_s": save_s, "restored_step": fresh["step"],
           "loss_uninterrupted": float(loss_after),
           "loss_restored": float(m["loss"]),
           "loss_bit_equal": bool(torch.equal(m["loss"], loss_after)),
           "weights_bit_equal": equal}
    log(json.dumps(rec))
    if not (equal and rec["loss_bit_equal"] and fresh["step"] == 10):
        raise AssertionError(f"resume differs from the run: {rec}")
    return rec_c


def train_cli(card: str, tmp: Path) -> None:
    """Phase 10 (d): `launch.train --scale smoke --steps 40
    --inject-failure-at 20` on the card."""
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (final, losses), wall = sync_s(lambda: train.main([
            "--scale", "smoke", "--steps", "40", "--inject-failure-at",
            "20", "--ckpt-dir", str(tmp), "--ckpt-every", "10"]))
    out = buf.getvalue()
    rec = {"phase": "train", "step": "d_cli", "card": card,
           "argv": "--scale smoke --steps 40 --inject-failure-at 20",
           "final_loss": final, "logged_losses": losses, "wall_s": wall,
           "restarts_1": "restarts=1" in out,
           "recovered": "recovered from step 20" in out}
    log(json.dumps(rec))
    if not (rec["restarts_1"] and rec["recovered"] and final < losses[0]):
        raise AssertionError(f"launch.train on the card: {rec}\n{out}")


def train_ring(card: str) -> None:
    """Phase 10 (e): the int8 ring over 4 logical devices of the card
    against the same call on the host."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import force_device_count, local_devices
    from repro_torch.sharding.compression import int8_ring_allreduce
    rng = np.random.default_rng(11)
    force_device_count(RING_DEVICES)
    try:
        out = {}
        for shape in ((1, 103), (1, 1 << 20)):
            x = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(RING_DEVICES)]
            card_out = int8_ring_allreduce(
                [torch.from_numpy(a).to(d)
                 for a, d in zip(x, local_devices())])
            host_out = int8_ring_allreduce(
                [torch.from_numpy(a).to(d)
                 for a, d in zip(x, local_devices("cpu"))])
            exact = sum(x)
            out[str(shape)] = {
                "bit_equal": all(torch.equal(c.cpu(), h)
                                 for c, h in zip(card_out, host_out)),
                "max_abs_diff": max(float((c.cpu() - h).abs().max())
                                    for c, h in zip(card_out, host_out)),
                "rel_err_vs_exact": float(np.abs(
                    host_out[0].numpy() - exact).max()
                    / np.abs(exact).max())}
    finally:
        force_device_count(None)
    log(json.dumps({"phase": "train", "step": "e_int8_ring", "card": card,
                    "devices": RING_DEVICES, "shapes": out}))
    if not all(v["bit_equal"] for v in out.values()):
        raise AssertionError(f"int8 ring: card differs from host: {out}")


def train_paths(card: str) -> tuple[dict, dict]:
    """Phase 10: training on the card.  -> (the six kernels' launches in
    it (none: training runs no kernel of the search path), (c)'s
    record)."""
    import tempfile
    import torch
    from repro_torch.device import full_fp32
    t_start = time.perf_counter()
    full_fp32()
    reset_launches()
    walls = {}
    for name, fn in (("a", train_fp32_checks), ("b", train_card_vs_host)):
        t0 = time.perf_counter()
        fn(card)
        free_card()
        walls[name] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        rec_c = train_run(card, Path(tmp) / "run")
        free_card()
        walls["c_d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_cli(card, Path(tmp) / "cli")
        walls["d_cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_ring(card)
    walls["e"] = time.perf_counter() - t0
    free_card()
    launches = kernel_launches()
    log(json.dumps({"phase": "train_done", "card": card,
                    "kernel_launches": launches, "walls_s": walls,
                    "wall_s": time.perf_counter() - t_start,
                    "peak_allocated_bytes": torch.cuda.max_memory_allocated()}))
    if any(launches.values()):
        raise AssertionError(f"training launched search kernels: {launches}")
    return launches, rec_c


# -------------------------------------------------------------- phase 11

DRYRUN_JOBS = 4                 # cells the background dry run traces at once
DRYRUN_WAIT_S = 300             # the longest phase 11 waits for it
PEAK_REL_BAR = 0.15             # (a): dry-run peak against the card's
SCAN_SEED = 23                  # (b): the ciphertext-shaped random data
LIB_ROWS = 1 << 17              # (b): rows of a library chunk


def start_dryrun() -> dict:
    """Phase 1: `python -m repro_torch.launch.dryrun --all --both-meshes
    --mesh 1card_h100` in the background, niced, DRYRUN_JOBS cells at a
    time, on the host (meta tensors: no card), its records and log in a
    temporary directory.  Its process group is killed and the directory
    removed at exit."""
    from repro_torch.launch import dryrun
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    out = tmp / "records"
    with open(tmp / "dryrun.log", "w") as log_f:
        proc = subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-m",
             "repro_torch.launch.dryrun", "--all", "--both-meshes",
             "--mesh", "1card_h100", "--jobs", str(DRYRUN_JOBS),
             "--out", str(out)],
            cwd=ROOT / "src", stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    atexit.register(stop)
    log(json.dumps({"phase": "dryrun", "step": "started",
                    "cells": len(dryrun.all_cells()),
                    "meshes": list(dryrun.MESH_NAMES),
                    "jobs": DRYRUN_JOBS}))
    return {"proc": proc, "out": out, "log": tmp / "dryrun.log",
            "t0": time.perf_counter()}


def dryrun_records(dry: dict) -> dict:
    """Phase 11's wait for the background run; every cell must have an
    ok record on all three meshes.  -> {(arch, shape, mesh): record}."""
    from repro_torch.launch import dryrun, roofline
    running = dry["proc"].poll() is None
    t0 = time.perf_counter()
    try:
        rc = dry["proc"].wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        raise AssertionError(
            f"the dry run did not end within {DRYRUN_WAIT_S} s of phase "
            f"11 ({time.perf_counter() - dry['t0']:.0f} s since its "
            f"start):\n{dry['log'].read_text()[-3000:]}") from None
    waited = time.perf_counter() - t0
    text = dry["log"].read_text()
    recs, bad = {}, []
    for arch, shape in dryrun.all_cells():
        for mesh in dryrun.MESH_NAMES:
            fn = dry["out"] / f"{arch}__{shape}__{mesh}.json"
            rec = json.loads(fn.read_text()) if fn.exists() else None
            if not (rec and rec.get("ok")):
                bad.append((arch, shape, mesh,
                            rec and rec.get("error", "")[:200]))
            recs[(arch, shape, mesh)] = rec
    summary = [ln for ln in text.splitlines() if "[dryrun] all:" in ln]
    log(json.dumps({"phase": "dryrun", "step": "records", "rc": rc,
                    "records": len(recs), "not_ok": len(bad),
                    "running_at_phase_11": running, "waited_s": waited,
                    "since_start_s": time.perf_counter() - dry["t0"],
                    "summary": summary[-1] if summary else None}))
    if rc != 0 or bad:
        raise AssertionError(f"dry run: rc {rc}, not ok {bad[:10]}\n"
                             f"{text[-3000:]}")
    for arch, shape in dryrun.all_cells():
        one = recs[(arch, shape, "1card_h100")]
        rows = {m: roofline.analyze_record(recs[(arch, shape, m)])
                for m in ("1card_h100", "1pod_256")}
        log(json.dumps({
            "phase": "dryrun", "step": "cell", "arch": arch, "shape": shape,
            "argument_bytes_1card": one["memory"]["argument_bytes"],
            "peak_bytes_1card": one["memory"]["peak_bytes"],
            "fits_one_card": one["fits_one_card"],
            "trace_s": one.get("trace_s"),
            **{f"roofline_{m}_s": {"compute": r.compute_s,
                                   "memory": r.memory_s,
                                   "collective": r.collective_s,
                                   "dominant": r.dominant}
               for m, r in rows.items()}}))
    return recs


def dryrun_phase_cells(card: str, lm_rec: dict, train_rec: dict) -> None:
    """(a) the cells phases 9 and 10 ran, dry-run on 1card_h100 as
    ShapeConfigs of their sizes: argument bytes equal to the bytes the
    phase allocated, the peak within PEAK_REL_BAR of the phase's measured
    one (arguments + the max_memory_allocated increment of one step);
    FLOPs and the roofline bound beside the measured step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models.config import ShapeConfig
    cells = [
        ("train", TRAIN_ARCH, ShapeConfig("phase10_train", "train", TRAIN_S,
                                          TRAIN_B),
         dict(opt="adamw", state_dtype="float32", n_micro=1,
              accum="float32"),
         train_rec["step0_argument_bytes"], train_rec["step0_peak_bytes"],
         train_rec["step_ms_p50"], train_rec["flops"]),
        ("decode", LM_ARCH, ShapeConfig("phase9_decode", "decode",
                                        LM_PROMPT + LM_NEW, LM_BATCH), None,
         lm_rec["decode_step_argument_bytes"],
         lm_rec["decode_step_peak_bytes"],
         lm_rec["decode_ms_per_step_median"], None)]
    for what, arch, sc, ts, args, peak, step_ms, flops in cells:
        cfg = get_config(arch)
        rec = dryrun.cell_record(arch, sc.name, "1card_h100", cfg=cfg, sc=sc,
                                 train_settings=ts)
        if not rec["ok"]:
            raise AssertionError(f"dry run of phase {what}: {rec['error']}")
        mem = rec["memory"]
        comp = (roofline.exec_flops(cfg, sc)["total"]
                / roofline.PEAK_BF16_FLOPS)
        mem_s = roofline.exec_bytes(cfg, sc, arch)["total"] / roofline.HBM_BW
        bound_ms = max(comp, mem_s) * 1e3
        out = {"phase": "dryrun", "step": "a", "cell": what, "card": card,
               "arch": arch, "dtype": cfg.dtype, "batch": sc.global_batch,
               "seq": sc.seq_len, "train_settings": ts,
               "argument_bytes_dryrun": mem["argument_bytes"],
               "argument_bytes_card": args,
               "argument_bytes_equal": mem["argument_bytes"] == args,
               "peak_bytes_dryrun": mem["peak_bytes"],
               "peak_bytes_card": peak,
               "peak_rel_gap": (mem["peak_bytes"] - peak) / peak,
               "temp_bytes_dryrun": mem["temp_bytes"],
               "temp_bytes_card": peak - args,
               "flops_dryrun": rec["cost"]["flops"],
               "flops_phase_model": flops,
               "roofline_compute_ms": comp * 1e3,
               "roofline_memory_ms": mem_s * 1e3,
               "roofline_bound_ms": bound_ms, "step_ms_card": step_ms,
               "share_of_bound": bound_ms / step_ms,
               "trace_s": rec["trace_s"], "bar": PEAK_REL_BAR}
        log(json.dumps(out))
        if not (out["argument_bytes_equal"]
                and abs(out["peak_rel_gap"]) <= PEAK_REL_BAR):
            raise AssertionError(f"dry run against phase {what}: {out}")


def scan_k1_record(Q, X, kp: int, home: str) -> dict:
    """K1 at a (b) shape against its plain version
    (`knn_against_plain`), device ms (median of 5; plain: one call), and
    the library's addmm + topk over LIB_ROWS-row chunks with a topk over
    the chunks' candidates, summed: the (nq, n) matrix does not fit
    beside the ciphertexts."""
    import torch
    from repro_torch.kernels.l2_topk import l2_topk
    nq, d = Q.shape
    n = X.shape[0]
    dt = str(X.dtype).removeprefix("torch.")
    checked = knn_against_plain(Q, X, kp)
    Qf = Q.float()
    qn = (Qf * Qf).sum(1)

    def library():
        best_d, best_i = [], []
        for s in range(0, n, LIB_ROWS):
            Xc = X[s:s + LIB_ROWS].float()
            v, i = torch.topk(torch.addmm(qn[:, None] + (Xc * Xc).sum(1),
                                          Qf, Xc.T, beta=1.0, alpha=-2.0),
                              kp, dim=1, largest=False)
            best_d.append(v)
            best_i.append(i + s)
        v, pos = torch.topk(torch.cat(best_d, 1), kp, dim=1, largest=False)
        return v, torch.gather(torch.cat(best_i, 1), 1, pos)

    return {
        "name": f"l2_topk.knn[nq={nq},n={n},d={d},k={kp}"
                + ("" if dt == "float32" else f",{dt}") + "]",
        "row_dtype": dt,
        "route": "cuda", "source": "src/repro_torch/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk/l2_topk.py:77", **checked,
        "ms": device_ms(lambda: l2_topk.knn(Q, X, kp), reps=5, warmup=1),
        "plain_ms": device_ms(lambda: l2_topk.plain_knn(Q, X, kp), reps=1,
                              warmup=0),
        "plain_reps": 1,
        "library_ms": device_ms(library, reps=3, warmup=1),
        "library_call": ("" if dt == "float32" else
                         f"each chunk of {dt} rows upcast, ")
                        + f"torch.addmm(qn+xn, Q, X.T, alpha=-2) + "
                        f"torch.topk over {-(-n // LIB_ROWS)} chunks of "
                        f"{LIB_ROWS} rows, then torch.topk over their "
                        f"candidates, summed (a ({nq}, {n}) fp32 matrix "
                        f"does not fit beside the ciphertexts)",
        "home": home}


def dryrun_scan(card: str, recs: dict) -> tuple[dict, list]:
    """(b) the paper's cell on one card: the first PPANNS_CELLS entry
    whose 1card_h100 record fits, on ciphertext-shaped random fp32 data
    drawn in place on the card; the sharded step over CARD_SHARDS logical
    shards against the global one (ids equal in 100% of slots, K1 and K2
    launched), device ms beside the roofline row; K1 and K2 at its
    shapes against their plain versions.  -> ({cell name: launches on
    its path}, kernel records)."""
    import torch
    from repro_torch.device import full_fp32
    from repro_torch.launch import dryrun, roofline
    from repro_torch.serving.secure_scan import (build_secure_scan_step,
                                                 build_secure_scan_step_gspmd)
    fits = [name for name in dryrun.PPANNS_CELLS
            if recs[("ppanns-scan", name, "1card_h100")]["fits_one_card"]]
    if not fits:
        raise AssertionError("no scan cell fits one card by its dry run")
    name = fits[0]
    cell = dryrun.PPANNS_CELLS[name]
    one = recs[("ppanns-scan", name, "1card_h100")]
    n, d, B, k, kp = (cell["n"], cell["d"], cell["batch"], cell["k"],
                      cell["k_prime"])
    D = 2 * d + 16
    full_fp32()
    free_card()
    free_before = torch.cuda.mem_get_info()[0]
    gen = torch.Generator(device="cuda").manual_seed(SCAN_SEED)
    t0 = time.perf_counter()
    data = {}
    for key, shape in (("C_sap", (n, d)), ("C_dce", (n, 4, D)),
                       ("Q_sap", (B, d)), ("T_q", (B, D))):
        data[key] = torch.empty(shape, device="cuda").normal_(generator=gen)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    args = tuple(data[key] for key in ("C_sap", "C_dce", "Q_sap", "T_q"))
    arg_bytes = sum(t.nbytes for t in args)
    devices = [torch.device("cuda", 0)] * dryrun.CARD_SHARDS
    sharded = build_secure_scan_step(devices, k=k, k_prime=kp)
    gspmd = build_secure_scan_step_gspmd(devices[:1], k=k, k_prime=kp)
    reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ids_s, cand_s = sharded(*args, with_candidates=True)
    torch.cuda.synchronize()
    peak = arg_bytes + torch.cuda.max_memory_allocated() - base
    on_sharded = kernel_launches()
    reset_launches()
    ids_g, cand_g = gspmd(*args, with_candidates=True)
    torch.cuda.synchronize()
    on_gspmd = kernel_launches()
    launches = {kk: on_sharded[kk] + on_gspmd[kk] for kk in on_sharded}
    with untallied():
        ms_s = device_ms(lambda: sharded(*args), reps=5, warmup=1)
        ms_g = device_ms(lambda: gspmd(*args), reps=5, warmup=1)
    row = roofline.analyze_record(one)
    rec = {"phase": "dryrun", "step": "b", "card": card, "cell": name,
           "why": (f"the first PPANNS_CELLS entry whose 1card_h100 record "
                   f"fits: peak {one['memory']['peak_bytes']} of "
                   f"{roofline.H100_MEMORY_BYTES} bytes"),
           "n": n, "d": d, "batch": B, "k": k, "k_prime": kp,
           "shards": dryrun.CARD_SHARDS, "operand_dtype": "float32",
           "free_bytes_before": free_before, "draw_s": draw_s,
           "argument_bytes_card": arg_bytes,
           "argument_bytes_dryrun": one["memory"]["argument_bytes"],
           "peak_bytes_card": peak,
           "peak_bytes_dryrun": one["memory"]["peak_bytes"],
           "ids_equal_gspmd": float((ids_s == ids_g).float().mean()),
           "candidates_equal_gspmd": float((cand_s == cand_g).float().mean()),
           "launches_sharded": on_sharded, "launches_gspmd": on_gspmd,
           "sharded_device_ms": ms_s, "gspmd_device_ms": ms_g,
           "roofline_1card_ms": {"compute": row.compute_s * 1e3,
                                 "memory": row.memory_s * 1e3,
                                 "collective": row.collective_s * 1e3,
                                 "dominant": row.dominant},
           "share_of_roofline_sharded": max(row.compute_s, row.memory_s)
           * 1e3 / ms_s,
           "share_of_roofline_gspmd": max(row.compute_s, row.memory_s)
           * 1e3 / ms_g}
    log(json.dumps(rec))
    if not (rec["ids_equal_gspmd"] == 1.0
            and arg_bytes == one["memory"]["argument_bytes"]
            and on_sharded["l2_topk.knn"] == dryrun.CARD_SHARDS
            and on_gspmd["l2_topk.knn"] == 1
            and on_sharded["dce_comp.refine_topk"] == 1
            and on_gspmd["dce_comp.refine_topk"] == 1):
        raise AssertionError(f"the scan cell on the card: {rec}")
    del ids_s, ids_g, cand_s
    free_card()
    per = n // dryrun.CARD_SHARDS
    kernels = [scan_k1_record(data["Q_sap"], data["C_sap"], kp, name),
               scan_k1_record(data["Q_sap"], data["C_sap"][:per], kp, name),
               refine_record(data["C_dce"], cand_g, data["T_q"], None, k,
                             name, reps=10)]
    for r in kernels:
        log(json.dumps(dict(r, card=card)))
    del data, args, cand_g
    free_card()
    return {name: launches}, kernels


SCAN16_REPS = {"scan_16m_bf16": 5, "scan_16m_bf16_b4096": 3}
PEAK_SCAN_BAR = 0.01            # (c): the card's peak against the dry run's


def dryrun_scan_16(card: str, recs: dict) -> tuple[dict, list]:
    """(c) the reference's bf16 cells at their sizes, nothing cut: one
    ciphertext-shaped corpus of 2^24 rows drawn in place in bf16 (C_sap
    and C_dce, 40.8 GB), bf16 queries and trapdoors a cell; the sharded
    step over CARD_SHARDS logical shards against the global one (ids
    equal in 100% of slots, K1 4 + 1 and K2 1 + 1 launches), device ms
    (median of SCAN16_REPS) beside the roofline row, argument bytes equal
    to the dry run's and the card's peak within PEAK_SCAN_BAR of its peak
    (a float32 copy of C_sap alone would add 8.6 GB).  For scan_16m_bf16
    also: K1 at one shard against its plain version; K1 on all rows
    against the float32 kernel on a float32 copy of C_sap (ids and
    distances bit-equal); K2 on the gathered candidates against their
    float32 copy (wins and ids bit-equal).  -> ({cell: launches on its
    path}, kernel records)."""
    import torch
    from repro_torch.kernels.dce_comp import dce_comp
    from repro_torch.kernels.l2_topk import l2_topk
    from repro_torch.launch import dryrun, roofline
    from repro_torch.serving.secure_scan import (build_secure_scan_step,
                                                 build_secure_scan_step_gspmd)
    names = list(SCAN16_REPS)
    cells = {nm: dryrun.PPANNS_CELLS[nm] for nm in names}
    n, d = cells[names[0]]["n"], cells[names[0]]["d"]
    assert all((c["n"], c["d"], c["dtype"]) == (n, d, "bfloat16")
               for c in cells.values())
    D = 2 * d + 16
    free_card()
    free_before = torch.cuda.mem_get_info()[0]
    gen = torch.Generator(device="cuda").manual_seed(SCAN_SEED + 1)
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    C_sap = torch.empty((n, d), dtype=bf16, device="cuda").normal_(
        generator=gen)
    C_dce = torch.empty((n, 4, D), dtype=bf16, device="cuda").normal_(
        generator=gen)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    devices = [torch.device("cuda", 0)] * dryrun.CARD_SHARDS
    on_paths, kernels = {}, []
    for name in names:
        cell, one = cells[name], recs[("ppanns-scan", name, "1card_h100")]
        B, k, kp = cell["batch"], cell["k"], cell["k_prime"]
        Q = torch.empty((B, d), dtype=bf16, device="cuda").normal_(
            generator=gen)
        T = torch.empty((B, D), dtype=bf16, device="cuda").normal_(
            generator=gen)
        args = (C_sap, C_dce, Q, T)
        arg_bytes = sum(t.nbytes for t in args)
        sharded = build_secure_scan_step(devices, k=k, k_prime=kp)
        gspmd = build_secure_scan_step_gspmd(devices[:1], k=k, k_prime=kp)
        reset_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ids_s, cand_s = sharded(*args, with_candidates=True)
        torch.cuda.synchronize()
        peak = arg_bytes + torch.cuda.max_memory_allocated() - base
        on_sharded = kernel_launches()
        reset_launches()
        ids_g, cand_g = gspmd(*args, with_candidates=True)
        torch.cuda.synchronize()
        on_gspmd = kernel_launches()
        on_paths[name] = {kk: on_sharded[kk] + on_gspmd[kk]
                          for kk in on_sharded}
        reps = SCAN16_REPS[name]
        with untallied():
            ms_s = device_ms(lambda: sharded(*args), reps=reps, warmup=1)
            ms_g = device_ms(lambda: gspmd(*args), reps=reps, warmup=1)
        row = roofline.analyze_record(one)
        dry_peak = one["memory"]["peak_bytes"]
        rec = {"phase": "dryrun", "step": "c", "card": card, "cell": name,
               "n": n, "d": d, "batch": B, "k": k, "k_prime": kp,
               "shards": dryrun.CARD_SHARDS, "operand_dtype": "bfloat16",
               "record_operand_dtype": one.get("operand_dtype"),
               "free_bytes_before": free_before, "draw_s": draw_s,
               "argument_bytes_card": arg_bytes,
               "argument_bytes_dryrun": one["memory"]["argument_bytes"],
               "peak_bytes_card": peak, "peak_bytes_dryrun": dry_peak,
               "peak_rel_gap": (peak - dry_peak) / dry_peak,
               "peak_bar": PEAK_SCAN_BAR,
               "ids_equal_gspmd": float((ids_s == ids_g).float().mean()),
               "candidates_equal_gspmd": float(
                   (cand_s == cand_g).float().mean()),
               "launches_sharded": on_sharded, "launches_gspmd": on_gspmd,
               "sharded_device_ms": ms_s, "gspmd_device_ms": ms_g,
               "reps": reps,
               "roofline_1card_ms": {"compute": row.compute_s * 1e3,
                                     "memory": row.memory_s * 1e3,
                                     "collective": row.collective_s * 1e3,
                                     "dominant": row.dominant},
               "share_of_roofline_sharded": max(row.compute_s, row.memory_s)
               * 1e3 / ms_s,
               "share_of_roofline_gspmd": max(row.compute_s, row.memory_s)
               * 1e3 / ms_g}
        log(json.dumps(rec))
        if not (rec["ids_equal_gspmd"] == 1.0
                and arg_bytes == one["memory"]["argument_bytes"]
                and one.get("operand_dtype") == "bfloat16"
                and abs(rec["peak_rel_gap"]) <= PEAK_SCAN_BAR
                and on_sharded["l2_topk.knn"] == dryrun.CARD_SHARDS
                and on_gspmd["l2_topk.knn"] == 1
                and on_sharded["dce_comp.refine_topk"] == 1
                and on_gspmd["dce_comp.refine_topk"] == 1):
            raise AssertionError(f"the bf16 scan cell on the card: {rec}")
        del ids_s, ids_g, cand_s
        if name == "scan_16m_bf16":
            kernels += scan_16_kernels(name, C_sap, C_dce, Q, T, cand_g, k,
                                       kp)
        del args, Q, T, cand_g
        free_card()
    for r in kernels:
        log(json.dumps(dict(r, card=card)))
    del C_sap, C_dce
    free_card()
    return on_paths, kernels


def scan_16_kernels(name, C_sap, C_dce, Q, T, cand, k: int,
                    kp: int) -> list:
    """(c)'s kernel checks at scan_16m_bf16's shapes: K1 at one shard and
    on all 2^24 bf16 rows against its plain version (`scan_k1_record`,
    each timed with its plain and library runs), and on all rows against
    the float32 kernel on a float32 copy of C_sap (8.6 GB, beside the
    40.8 GB corpus): ids and distances bit-equal; K2 on the
    global step's candidates against the float32 kernel on the gathered
    rows' float32 copy: wins and ids bit-equal."""
    import torch
    from repro_torch.kernels.dce_comp import dce_comp
    from repro_torch.kernels.l2_topk import l2_topk
    from repro_torch.launch import dryrun
    per = C_sap.shape[0] // dryrun.CARD_SHARDS
    shard = scan_k1_record(Q, C_sap[:per], kp, name)
    whole = scan_k1_record(Q, C_sap, kp, name)
    got = l2_topk.knn(Q, C_sap, kp)
    X32 = C_sap.float()
    want = l2_topk.knn(Q.float(), X32, kp)
    whole["bit_equal_to_float32_kernel"] = k1_equal = equal_outputs(got,
                                                                   want)
    del got, want
    whole["ms_float32_copy"] = device_ms(
        lambda: l2_topk.knn(Q.float(), X32, kp), reps=5, warmup=1)
    del X32
    free_card()
    args = (C_dce, cand, T, None, k)
    ids, wins = dce_comp.refine_topk(*args, return_wins=True)
    Cc = C_dce[cand].float().reshape(-1, 4, C_dce.shape[-1])
    local = torch.arange(Cc.shape[0], device=Cc.device).reshape(cand.shape)
    ids32, wins32 = dce_comp.refine_topk(Cc, local, T.float(), None, k,
                                         return_wins=True)
    k2_equal = (torch.equal(wins, wins32)
                and torch.equal(ids, torch.gather(cand, 1, ids32 - local[:, :1])))
    ms32_k2 = device_ms(lambda: dce_comp.refine_topk(Cc, local, T.float(),
                                                      None, k), reps=10)
    del Cc, local
    refine = dict(refine_record(*args, name, reps=10),
                  bit_equal_to_float32_kernel=k2_equal,
                  ms_float32_copy=ms32_k2)
    if not (k1_equal and k2_equal):
        raise AssertionError(f"(c) bit-equality with the float32 kernels: "
                             f"K1 {k1_equal}, K2 {k2_equal}")
    return [shard, whole, refine]


def dryrun_paths(card: str, dry: dict, lm_rec: dict,
                 train_rec: dict) -> tuple[dict, list]:
    """Phase 11: the dry run held against the card.  -> ({(b)'s cell:
    launches on its path}, its kernel records)."""
    import torch
    from repro_torch.launch import roofline
    t_start = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    if total != roofline.H100_MEMORY_BYTES:
        raise AssertionError(f"the card holds {total} bytes; the dry run's "
                             f"H100_MEMORY_BYTES is "
                             f"{roofline.H100_MEMORY_BYTES}")
    recs = dryrun_records(dry)
    dryrun_phase_cells(card, lm_rec, train_rec)
    on_scan, kernels = dryrun_scan(card, recs)
    on_16, kernels_16 = dryrun_scan_16(card, recs)
    on_scan.update(on_16)
    kernels += kernels_16
    log(json.dumps({"phase": "dryrun_done", "card": card,
                    "total_memory": total, "kernel_launches": on_scan,
                    "wall_s": time.perf_counter() - t_start}))
    return on_scan, kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="flat path rows (default: SIFT1M's 1,000,000)")
    ap.add_argument("--graph-n", type=int, default=50_000,
                    help="graph path rows (default 50,000: the host HNSW "
                         "build takes minutes)")
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # phase 1 -------------------------------------------------------
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib.name}")
    for line in Path(str(lib) + ".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())
    dry = start_dryrun()            # phase 11's records, on the host

    # the pool's exit terminates the workers, also on a failure: the
    # owner's global HNSW, phase 8's per-shard subgraphs and phase 4's
    # pq8 codebook
    with multiprocessing.get_context("spawn").Pool(2 + SHARDS) as pool:
        graph = graph_setup(args.graph_n, args.queries, pool)
        start_shard_graphs(graph, pool)
        corpus = flat_corpus(args.n, args.queries)
        corpus["pq_job"] = pool.apply_async(train_pq, (
            corpus["C_sap"], PQ_M, PQ_SEED))

        # phase 2 ---------------------------------------------------
        gen = torch.Generator(device="cuda").manual_seed(0)
        records = [check_knn(32, 1_000_000, 128, K * RATIO_K, gen),
                   check_knn(32, 2 ** 18, 960, K * RATIO_K, gen),
                   check_knn(32, 50, 128, K * RATIO_K, gen),
                   check_refine(32, 80, 128, K, gen, "flat"),
                   check_refine(32, 160, 128, K, gen, "adc_int8"),
                   check_refine(32, 320, 128, K, gen, "adc_pq8"),
                   check_l2(32, 4096, 128, gen),
                   check_l2(32, 4096, 960, gen),
                   check_z(32, 80, 128, gen), check_z(32, 80, 960, gen),
                   check_z(32, 160, 128, gen), check_z(32, 320, 128, gen),
                   check_z(1, 512, 128, gen, single=True),
                   check_graph_walk(2 ** 17, 16, 8, 8, 128, gen),
                   check_graph_walk(2 ** 20, 32, 16, 8, 128, gen),
                   check_graph_walk(2 ** 17, 32, 16, 8, 960, gen),
                   check_graph_walk(2 ** 21, 16, 8, 8, 128, gen),
                   check_graph_walk(2 ** 17, 16, 8, 8, 128, gen, ef=1600,
                                    ef_cap=2048, max_hops=8192),
                   check_graph_expand(2 ** 17, 16, 128, gen),
                   check_graph_expand(2 ** 20, 32, 128, gen),
                   check_graph_expand(2 ** 17, 32, 960, gen),
                   check_sq_adc(32, 1_000_000, 128, 160, gen),
                   check_sq_adc(32, 2 ** 18, 960, 160, gen),
                   check_sq_adc(32, 100, 128, 30, gen, n_valid=12),
                   # the int8 cell's shape
                   check_sq_adc(1024, 1_000_000, 128, 160, gen),
                   *[check_sq_encode(nq, d) for nq in (1024, 32)
                     for d in (128, 960)],
                   check_pq_adc(32, 16, 1_000_000, 320, gen),
                   check_pq_adc(32, 8, 2 ** 18, 320, gen),
                   check_knn(32, 1_000_000, 128, 1600, gen,
                             home="flat_k1600", exact=True),
                   check_sq_adc(32, 1_000_000, 128, 1600, gen,
                                home="adc_int8_k1600"),
                   check_pq_adc(32, 16, 1_000_000, 1600, gen,
                                home="adc_pq8_k1600"),
                   # phase 8's per-shard shapes: a quarter of the 1M
                   # rows (flat, int8) or of the 50k graph corpus (pq8,
                   # the subgraphs' R)
                   check_knn(32, 2 ** 18, 128, K * RATIO_K, gen,
                             home="sharded_flat"),
                   check_sq_adc(32, 2 ** 18, 128, 160, gen,
                                home="sharded_int8"),
                   check_pq_adc(32, 16, 2 ** 14, 320, gen,
                                home="sharded_pq8"),
                   check_graph_walk(2 ** 14, 16, 8, 8, 128, gen,
                                    home="sharded_graph"),
                   # phase 9's kNN-LM shapes: B 4 probes of d_model
                   # 2048 over 100,000 rows, k' = 8 k, D = 4112
                   check_knn(LM_BATCH, KNN_N, 2048, KNN_K * RATIO_K, gen,
                             home="knn_lm"),
                   check_refine(LM_BATCH, KNN_K * RATIO_K, 2048, KNN_K,
                                gen, "knn_lm"),
                   # 16-bit rows read in place (phase 3's scan forms run
                   # them): the flat path's K1 and the refines' K2 shapes
                   *[check_knn_16(32, 1_000_000, 128, K * RATIO_K, gen, dt,
                                  SCAN_HOME[dt]) for dt in HALF_DTYPES],
                   *[check_refine_16(32, n, 128, K, gen, dt,
                                     SCAN_HOME[dt] if n == K * RATIO_K
                                     else NO_PATH)
                     for dt in HALF_DTYPES for n in (80, 320)],
                   # the tile and Z entries on 16-bit rows (no path); the
                   # Z entry at n 512 (RI 2) and n 640 (RI 3, whose 16-bit
                   # build spills 4 bytes)
                   *[check_l2(32, 4096, 128, gen, dt) for dt in HALF_DTYPES],
                   *[check_z(1, n, 128, gen, single=True, dtype=dt)
                     for dt in HALF_DTYPES for n in (512, 640)]]
        for r in records:
            log(json.dumps(dict(r, card=card)))
        gc.collect()
        torch.cuda.empty_cache()

        # phase 3 ---------------------------------------------------
        small_reference_check()
        flat, flat_k1600, corpus = main_path(corpus)
        gc.collect()                    # the flat engine is gone: free
        torch.cuda.empty_cache()        # its 4.9 GB before the ADC paths
        on_forms = scan_forms(corpus)
        gc.collect()
        torch.cuda.empty_cache()

        # phase 4, its pq8 engine last (below) --------------------
        on_adc = {"flat_k1600": flat_k1600}

        def phase4(path, quant, backend):
            on_adc[path], k1600 = adc_path(corpus, quant, backend)
            if k1600 is not None:
                on_adc[f"{path}_k1600"] = k1600
            gc.collect()
            torch.cuda.empty_cache()
        phase4("adc_int8", "int8", "flat")
        phase4("ivf_int8", "int8", "ivf")

        # phase 6 ---------------------------------------------------
        on_runtime = runtime_paths(corpus, graph, records)

        # phase 7 ---------------------------------------------------
        on_api = api_paths(corpus, graph)

        # phase 8 ---------------------------------------------------
        on_sharded, rec_sharded_graph = sharded_paths(corpus, graph)

        # phase 9 ---------------------------------------------------
        on_lm, lm_rec = lm_paths(card)

        # phase 10 --------------------------------------------------
        on_train, train_rec = train_paths(card)

        # phase 4's pq8 engine, after the worker's codebook ------------
        phase4("adc_pq8", "pq8", "flat")
        del corpus
        gc.collect()
        torch.cuda.empty_cache()

        # phase 5 ---------------------------------------------------
        on_graph = graph_path(graph)
        for r in graph["half_records"]:
            log(json.dumps(dict(r, card=card)))
        records += graph["half_records"]
        log(json.dumps({"phase": "sharded_path", "step": "e_recall",
                        "path": "sharded_graph",
                        "recall@10_sharded": rec_sharded_graph["recall@10"],
                        "recall@10_global_graph": graph["recall_global"]}))

    # phase 11, last, on an emptied card -------------------------------
    on_graph16 = graph["half_paths"]
    del graph
    free_card()
    on_scan, scan_records = dryrun_paths(card, dry, lm_rec, train_rec)
    records += scan_records

    paths = {"flat": flat, "graph": on_graph, **on_adc, **on_runtime,
             **on_api, **on_sharded, **on_lm, "train": on_train, **on_scan,
             **on_forms, **on_graph16}
    # launches: on the path the kernel was ported for (or the record's
    # own, where its shape is another path's); launches_by_path: on each
    home = {"l2_topk.knn": "flat", "l2_topk.pairwise_sq_dists": "flat",
            "dce_comp.refine_topk": "flat",
            "dce_comp.batched_z_matrix": "flat",
            "graph_expand.graph_walk": "graph",
            "graph_expand.expand_layer0": "graph",
            "adc_topk.sq_adc_topk": "adc_int8",
            "adc_topk.sq_encode_queries": "adc_int8",
            "adc_topk.pq_adc_topk": "adc_pq8"}
    for r in records:
        kern = r["name"].split("[")[0]
        kern = {"dce_comp.z_matrix": "dce_comp.batched_z_matrix"}.get(
            kern, kern)                  # z_matrix is the B = 1 kernel
        path = r.pop("home", home[kern])
        r.setdefault("row_dtype", {"adc_topk.sq_adc_topk": "int8",
                                   "adc_topk.pq_adc_topk": "uint8"}.get(
                                       kern, "float32"))
        r["launches"] = 0 if path == NO_PATH else paths[path][kern]
        r["launches_on"] = None if path == NO_PATH else path
        r["launches_by_path"] = {p: c[kern] for p, c in paths.items()}
    log(json.dumps({"phase": "done",
                    "wall_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
