"""Serve entry point, the counterpart of `repro.launch.serve`: builds a model
(random weights from a seed), runs batched prefill+decode, and
optionally attaches the PP-ANNS retrieval sidecar (the paper's secure
k-NN as a serving feature) through the typed public API: a keyless
`SecureAnnService` hosts the collection, a `DataOwnerClient` encrypts
the corpus, and concurrent `QueryClient` requests coalesce in the
service's micro-batcher.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 32 --new-tokens 16 --secure-ann

Like the reference it runs `cfg.smoke()`.  `--device` picks where the
model, the owner's encryption and the service run: the card by default,
`cpu` for the plain PyTorch versions on the host.
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.api import (DataOwnerClient, IndexSpec, PlacementSpec,
                             SearchParams, SecureAnnService, suggest_beta)
from repro_torch.configs import get_config
from repro_torch.data import synth
from repro_torch.models import Model
from repro_torch.serving import LMServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--secure-ann", action="store_true",
                    help="attach the PP-ANNS retrieval sidecar")
    ap.add_argument("--ann-db-size", type=int, default=5000)
    ap.add_argument("--ann-shards", type=int, default=0,
                    help="row-shard the ANN collection over this many "
                         "devices (0 = single-device placement; -1 = "
                         "every local device) — DESIGN.md §10")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus metrics for the ANN sidecar on "
                         "this port (0 = disabled) — DESIGN.md §13")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace JSON of the ANN sidecar's "
                         "request spans to this path on exit")
    ap.add_argument("--device", default=None,
                    help="where everything runs: the card by default, "
                         "'cpu' for the plain versions on the host")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    model = Model(cfg, device=args.device, seed=0)
    server = LMServer(model)

    gen = torch.Generator(device=model.device).manual_seed(1)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
        device=model.device, dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn(
            (args.batch, cfg.n_vision_tokens, cfg.d_model), generator=gen,
            device=model.device)
    if cfg.family == "encdec":
        batch["enc_input"] = torch.randn(
            (args.batch, cfg.enc_seq_len, cfg.d_model), generator=gen,
            device=model.device)

    t0 = time.time()
    out = server.generate(batch, args.new_tokens)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    tok_s = args.batch * args.new_tokens / dt
    print(f"[serve] generated {tuple(out.shape)} in {dt:.2f}s "
          f"({tok_s:.1f} tok/s)")

    if args.secure_ann:
        print("[serve] starting PP-ANNS service sidecar "
              f"({args.ann_db_size} encrypted vectors)...")
        d = min(cfg.d_model, 128)
        ds = synth.make_dataset("sift1m", n=args.ann_db_size, n_queries=16,
                                d=d, k_gt=10, seed=0)
        spec = IndexSpec(tenant="serve-demo", name="rag", d=d,
                         backend="flat",
                         sap_beta=suggest_beta(ds.base, fraction=0.03),
                         max_wait_ms=4.0, seed=0)
        placement = None
        if args.ann_shards:
            placement = PlacementSpec(
                kind="sharded",
                n_shards=None if args.ann_shards < 0 else args.ann_shards)
        want_obs = bool(args.metrics_port or args.trace_out)
        with SecureAnnService(obs=want_obs or None,
                              device=args.device) as svc:
            metrics_server = None
            if args.metrics_port:
                from repro_torch.obs import start_metrics_server
                metrics_server = start_metrics_server(
                    svc, args.metrics_port)
                print("[serve] metrics at http://localhost:"
                      f"{metrics_server.server_address[1]}/metrics")
            svc.create_collection(spec, placement=placement)
            owner = DataOwnerClient(spec)       # keys stay client-side
            t0 = time.time()
            C_sap, C_dce = owner.encrypt_vectors(ds.base, device=args.device)
            svc.insert(spec.tenant, spec.name, C_sap, C_dce)
            svc.compact(spec.tenant, spec.name)
            print(f"[serve] ingested {args.ann_db_size} vectors "
                  f"(batched DCPE+DCE encrypt) in {time.time() - t0:.2f}s")
            svc.warmup(spec.tenant, spec.name, k=10)
            user = owner.query_client()
            reqs = [user.request(spec.tenant, spec.name, q,
                                 SearchParams(k=10)) for q in ds.queries]
            t0 = time.time()
            with ThreadPoolExecutor(len(reqs)) as pool:   # concurrent
                results = list(pool.map(svc.submit, reqs))
            ids = np.concatenate([r.ids for r in results])
            dt = time.time() - t0
            rec = synth.recall_at_k(ids, ds.gt, 10)
            snap = svc.stats(spec.tenant, spec.name)
            print(f"[serve] secure 10-NN over {args.ann_db_size} vectors: "
                  f"recall@10={rec:.3f} in {dt:.2f}s "
                  f"(occupancy={snap['batch_occupancy']:.1f}, "
                  f"p99={1e3 * snap['p99_latency_s']:.1f}ms)")
            if args.trace_out:
                svc.export_chrome_trace(args.trace_out)
                print(f"[serve] wrote Chrome trace to {args.trace_out}")
            if metrics_server is not None:
                metrics_server.shutdown()
    return out


if __name__ == "__main__":
    main()
