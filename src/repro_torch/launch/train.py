"""Train entry point, the counterpart of `repro.launch.train`: config -> mesh
-> train loop with checkpointing, auto-resume and failure recovery.  The
mesh is data here (one card; nothing is placed): it sizes the run and
is recorded in each checkpoint's manifest, and `--production-mesh`
needs its 256 devices, as on the reference's host.

Runs on the card unless `--device cpu` is given; `--scale smoke` is the
reference's widened smoke config (d_model 256, d_ff 1024, up to 4
layers), `--scale full` the arch at its published width.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --scale smoke --steps 200 --batch 8 --seq 64 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --scale smoke --steps 40 --inject-failure-at 20 --ckpt-dir ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data.loader import TokenStream
from repro_torch.ft import ResilientRunner, RetryPolicy
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.training import OptConfig, build_train_step, init_train_state
from repro_torch.training.train_loop import (abstract_train_state,
                                             state_from_tree, state_tree)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 devices)")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="raise at this step once (FT drill)")
    ap.add_argument("--device", default=None,
                    help="where training runs: the card by default, 'cpu' "
                         "for the plain PyTorch versions on the host")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = cfg.smoke()
        # widen a bit so the run is a meaningful ~10-100M-param model
        cfg = dataclasses.replace(cfg, d_model=256, d_ff=1024,
                                  n_layers=min(cfg.n_layers + 2, 4))
    mesh = (make_production_mesh(device=args.device)
            if args.production_mesh else make_host_mesh(args.device))
    model = Model(cfg, device=args.device, seed=0)

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)
    step_fn = build_train_step(model, opt_cfg, n_microbatches=args.n_micro)

    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=0, markov_temp=0.3)

    def restore():
        tree, manifest = restore_checkpoint(
            args.ckpt_dir, state_tree(abstract_train_state(model, opt_cfg)),
            device=model.device)
        return manifest["step"], state_from_tree(tree)

    # ---- init or resume
    start_step = 0
    state = init_train_state(model, opt_cfg)
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start_step, state = restore()
        stream.step = start_step
        print(f"[train] resumed from step {start_step}")

    def save_fn(step, st):
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, step, state_tree(st), mesh=mesh,
                            extra={"arch": args.arch})

    def restore_fn():
        step, st = restore()
        print(f"[train] recovered from step {step}")
        return step, st

    fail_at = {args.inject_failure_at} if args.inject_failure_at >= 0 else set()
    t0 = time.time()
    losses = []

    def wrapped_step(st, batch):
        step_now = int(st["step"])
        if step_now in fail_at:
            fail_at.discard(step_now)
            raise RuntimeError(f"injected failure at step {step_now}")
        st, metrics = step_fn(st, batch)
        if step_now % args.log_every == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"[train] step {step_now:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)")
        return st, metrics

    def get_batch(step):
        stream.step = step           # deterministic in step (replayable)
        return {k: torch.as_tensor(v, device=model.device)
                for k, v in stream.next().items()}

    runner = ResilientRunner(wrapped_step, save_fn, restore_fn,
                             RetryPolicy(max_restarts=3),
                             checkpoint_every=args.ckpt_every)
    if args.ckpt_dir:
        save_fn(start_step, state)
    state, step, metrics = runner.run(state, start_step,
                                      args.steps - start_step, get_batch)
    if args.ckpt_dir:
        save_fn(step, state)
    final_loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"[train] done at step {step}; final loss {final_loss:.4f}; "
          f"restarts={runner.restarts}")
    return final_loss, losses


if __name__ == "__main__":
    main()
