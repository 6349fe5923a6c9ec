"""train_embedder CLI: produce AdaFace/ArcFace/CosFace backbone checkpoints.

Counterpart of `facerecognitionpipeline_tpu/cli/train_embedder.py`, with
its flags plus --device (default cuda; raises without a card, never falls
back to the CPU). An identity-folder dataset (or --synthetic_classes) ->
margin-softmax training (`train/trainer.py`) -> step-numbered checkpoints
with resume (`train/checkpoint.py`) -> a `.npz` backbone export that
`FaceEmbedder(model_path=...)` of either package loads.

--data_parallel and --model_parallel above 1 train over a mesh
(`parallel.make_mesh`): the batch split over the data axis, the classifier
over the model axis (the class count padded to a multiple of it). On the
card the mesh takes distinct CUDA devices; with --device cpu it is
data x model CPU entries, as the JAX package's virtual CPU devices are. A
checkpoint written under a mesh resumes under the same mesh. --bf16
computes in bfloat16 with float32 parameters. Losses stay on the device
and are fetched once per log window.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a face-embedding backbone")
    p.add_argument("--data_dir", type=str, default=None,
                   help="Dataset root: one folder of aligned 112x112 crops "
                        "per identity")
    p.add_argument("--synthetic_classes", type=int, default=0,
                   help="Train on synthetic per-class patterns instead of "
                        "--data_dir (smoke tests / benchmarking)")
    p.add_argument("--architecture", type=str, default="ir_50",
                   choices=sorted(BACKBONE_CONFIGS))
    p.add_argument("--loss", type=str, default="adaface",
                   choices=["adaface", "arcface", "cosface"])
    p.add_argument("--margin", type=float, default=0.4)
    p.add_argument("--scale", type=float, default=64.0)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--prefetch", type=int, default=0,
                   help="batches staged on the card ahead of the step (0 = "
                        "upload each batch when its step starts)")
    p.add_argument("--learning_rate", type=float, default=0.1)
    p.add_argument("--lr_schedule", choices=("constant", "cosine", "step"),
                   default="constant",
                   help="'step' follows the AdaFace x0.1 milestones scaled "
                        "to --steps; 'cosine' decays to 0 over --steps")
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="data axis size (0 = every device the model axis "
                        "leaves; 1 with --device cpu)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model axis size: classifier shards")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay f32)")
    p.add_argument("--optax_optimizer", action="store_true",
                   help="the unfused add-decay -> trace -> scale -> apply "
                        "chain instead of the fused update (same "
                        "trajectory). Its optimizer state has another "
                        "structure: a checkpoint resumes only under the "
                        "setting it was saved with")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints/embedder")
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export_path", type=str, default=None,
                   help="Write the final backbone .npz here")
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from facerecognitionpipeline_tpu_torch.train.checkpoint import (
        export_backbone,
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from facerecognitionpipeline_tpu_torch.train.data import (
        FolderDataset,
        folder_batches,
        prefetch_to_device,
        synthetic_batches,
    )
    from facerecognitionpipeline_tpu_torch.parallel.mesh import make_mesh
    from facerecognitionpipeline_tpu_torch.train.trainer import TrainConfig, Trainer
    from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"Device: {device}")
    n_model = max(1, args.model_parallel)
    mesh = None
    if args.data_parallel > 1 or n_model > 1:
        if device.type == "cpu":
            n_data = max(1, args.data_parallel)
            mesh = make_mesh(data=n_data, model=n_model, devices=[device] * (n_data * n_model))
        else:
            mesh = make_mesh(data=args.data_parallel or None, model=n_model)
        print(f"Mesh: data={mesh.shape['data']} x model={n_model}")

    if args.synthetic_classes:
        num_classes = args.synthetic_classes
    else:
        if not args.data_dir:
            raise SystemExit("Provide --data_dir or --synthetic_classes")
        dataset = FolderDataset(args.data_dir)
        num_classes = dataset.num_classes
        print(f"Dataset: {len(dataset)} images / {num_classes} identities")

    # the class-sharded head wants num_classes divisible by the model axis
    padded_classes = -(-num_classes // n_model) * n_model
    cfg = TrainConfig(
        architecture=args.architecture,
        num_classes=padded_classes,
        loss=args.loss,
        margin=args.margin,
        scale=args.scale,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        lr_schedule=args.lr_schedule,
        total_steps=args.steps,
        warmup_steps=args.warmup_steps,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        fused_optimizer=not args.optax_optimizer,
    )
    trainer = Trainer(cfg, mesh, device=device)
    state = trainer.init_state(args.seed)

    start_step = 0
    if args.resume and latest_step(args.checkpoint_dir) is not None:
        state = restore_checkpoint(args.checkpoint_dir, state)
        start_step = int(state["step"])
        print(f"Resumed from step {start_step}")

    # the stream seed is offset by the resumed step, so a resumed run goes on
    # with fresh batches instead of replaying the first ones
    stream_seed = args.seed + start_step
    if args.synthetic_classes:
        batches = synthetic_batches(num_classes, args.batch_size, stream_seed)
    else:
        batches = folder_batches(dataset, args.batch_size, seed=stream_seed)
    if args.prefetch > 0:
        batches = prefetch_to_device(batches, depth=args.prefetch, device=device,
                                     sharding=mesh)

    t0 = time.perf_counter()
    losses: list = []
    pending: list = []  # loss tensors on the card, fetched once per log window
    for step_i, (images, labels) in enumerate(batches, start=start_step):
        if step_i >= args.steps:
            break
        state, metrics = trainer.train_step(
            state, images, labels, trainer.dropout_generators(args.seed, step_i))
        pending.append(metrics["loss"])
        if (step_i + 1) % args.log_every == 0:
            losses.extend(torch.stack(pending).cpu().tolist())
            pending = []
            rate = args.log_every * args.batch_size / (time.perf_counter() - t0)
            print(
                f"step {step_i + 1}/{args.steps} "
                f"loss {np.mean(losses[-args.log_every:]):.4f} "
                f"({rate:.0f} img/s)"
            )
            t0 = time.perf_counter()
        if (step_i + 1) % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint_dir, state, step_i + 1)
            print(f"checkpoint @ step {step_i + 1}")

    if pending:
        losses.extend(torch.stack(pending).cpu().tolist())
    final_step = int(state["step"])
    save_checkpoint(args.checkpoint_dir, state, final_step)
    if args.export_path:
        export_backbone(state, args.export_path)
        print(f"Exported backbone -> {args.export_path}")
    last = f"{losses[-1]:.4f}" if losses else "n/a (no steps ran)"
    print(f"Training done at step {final_step}; final loss {last}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
