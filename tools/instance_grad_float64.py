#!/usr/bin/env python3
"""How far SOLOLite's float32 gradient on the card lies from float64, and why.

    python3 tools/instance_grad_float64.py      # on a machine with the card

One batch of 8 instance samples at the shipped recipe's widths (f=48,
patch 128; the batch and weights of ``chip_smoke.py`` phase 21's float32
step) and its ``solo_loss`` gradient in float64 on the CPU, from the
plain extraction's images, as the yardstick. Then the relative L2
distance to it of float32 gradients: the CPU's, and the card's with
cuDNN's default, deterministic and benchmarked algorithms and with cuDNN
off, each fed K4's images, the plain extraction's on the card and the
CPU's. The largest per-parameter distances are printed beside each.
Imports nothing of JAX.
"""

import copy
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED = 20260817  # chip_smoke.py's
MODEL = {"num_classes": 6, "grid_size": 8, "features": 48, "embed_dim": 48}


def main():
    if not torch.cuda.is_available():
        print("instance_grad_float64: no CUDA device", file=sys.stderr)
        return 1
    from rfi_toolbox_tpu_torch.models import SOLOLite, solo_loss
    from rfi_toolbox_tpu_torch.ops import fused_extract_channels, fused_extract_channels_plain
    from rfi_toolbox_tpu_torch.train import InstanceTrainer
    from rfi_toolbox_tpu_torch.utils import set_tf32

    set_tf32(False)
    dev = torch.device("cuda")
    cpu = InstanceTrainer(model=SOLOLite(**MODEL), patch_size=128, batch_size=8, seed=SEED,
                          device="cpu")
    cpu._init()
    card = InstanceTrainer(model=SOLOLite(**MODEL), patch_size=128, batch_size=8, seed=SEED)
    batch = card.generate_batch(torch.Generator(device=dev).manual_seed(SEED + 21))
    targets = [batch[k] for k in ("inst_masks", "inst_classes", "inst_valid")]
    names = [n for n, _ in cpu.model.named_parameters()]

    def grads(model, images, targets):
        loss = solo_loss(model(images), *targets)[0]
        return [g.detach().cpu().double()
                for g in torch.autograd.grad(loss, list(model.parameters()))]

    plain_cpu = fused_extract_channels_plain(batch["waterfall"].cpu())
    targets_cpu = [t.cpu() for t in targets]
    g64 = grads(copy.deepcopy(cpu.model).double(), plain_cpu.double(), targets_cpu)
    norm64 = sum((g ** 2).sum() for g in g64) ** 0.5

    def report(label, gs):
        dist = float(sum(((a - b) ** 2).sum() for a, b in zip(gs, g64)) ** 0.5 / norm64)
        worst = sorted(((float((a - b).norm() / b.norm()), n)
                        for a, b, n in zip(gs, g64, names)), reverse=True)[:3]
        print(f"{label}: {dist:.3e} from float64; largest " + ", ".join(
            f"{n} {d:.2e}" for d, n in worst), flush=True)

    report("CPU float32, plain images", grads(cpu.model, plain_cpu, targets_cpu))
    k4 = fused_extract_channels(batch["waterfall"])
    plain = fused_extract_channels_plain(batch["waterfall"])
    print(f"images: K4 against the plain extraction on the card, max |d| "
          f"{float((k4 - plain).abs().max()):.3e}; the card's plain against the CPU's "
          f"{float((plain.cpu() - plain_cpu).abs().max()):.3e}", flush=True)
    model = copy.deepcopy(cpu.model).to(dev, memory_format=torch.channels_last)
    cudnn = torch.backends.cudnn
    for label, flags in (("cuDNN default", {}), ("cuDNN deterministic", {"deterministic": True}),
                         ("cuDNN benchmark", {"benchmark": True}),
                         ("cuDNN off", {"enabled": False})):
        saved = {k: getattr(cudnn, k) for k in ("deterministic", "benchmark", "enabled")}
        for k, v in flags.items():
            setattr(cudnn, k, v)
        try:
            for which, images in (("K4", k4), ("plain", plain), ("the CPU's", plain_cpu.to(dev))):
                report(f"card float32, {label}, {which} images",
                       grads(model, images, targets))
        finally:
            for k, v in saved.items():
                setattr(cudnn, k, v)
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
