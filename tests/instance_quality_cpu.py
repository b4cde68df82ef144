"""Held-out quality of the shipped SOLOLite detector in float32 on the CPU,
on JAX's instance stream and on the port's.

Not a test (pytest does not collect it): a measurement that takes
minutes. Each image goes through the port's ``InstanceTrainer.predict``
(which equals the JAX ``predict`` image for image:
``test_torch_instance.py::test_held_out_matches_jax_on_the_shipped_snapshot``)
and ``match_instances``.

- default: ``--images`` images of JAX's stream (keys ``key(seed + j)``,
  batches of 32) and of the port's (``evaluate_instance_model`` at
  ``--port-seed``): the float32 recall against which ``chip_smoke.py``
  phase 20 holds the card's all-six gate;
- ``--jax-gates``: tests/test_instance_quality.py's own held-out sets
  (JAX's stream at seed 10 000: 16 images in batches of 8, 64 in
  batches of 16), as its ``evaluate_instance_model`` draws them;
- ``--bf16-pass``: every conv's operands rounded to bfloat16 and summed
  in float32, as a TPU computes a float32 conv at JAX's default
  precision.

    python tests/instance_quality_cpu.py --images 2048 --mix all6
    python tests/instance_quality_cpu.py --jax-gates
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SNAPSHOT = ROOT / "pretrained" / "sololite_synthetic.npz"
MIXES = {
    "all6": ({"narrowband_persistent": {"count": [1, 3]},
              "broadband_persistent": {"count": [0, 2]},
              "narrowband_intermittent": {"count": [0, 2]},
              "narrowband_bursty": {"count": [0, 2]},
              "broadband_bursty": {"count": [0, 1]},
              "frequency_sweep": {"count": [0, 1]}}, 0.25),
    "default": ({"narrowband_persistent": {"count": [1, 3]},
                 "broadband_persistent": {"count": [0, 2]},
                 "narrowband_bursty": {"count": [0, 2]},
                 "frequency_sweep": {"count": [0, 1]}}, 0.3),
}


def jax_batches(cfg, keys, batch):
    """JAX's instance batches, one for each key, with their images."""
    import jax
    from jax import random

    from rfi_toolbox_tpu.preprocess import pipeline as JP
    from rfi_toolbox_tpu.synth.sample import make_instance_sample_generator

    fn = jax.jit(jax.vmap(make_instance_sample_generator(128, 128, rfi_config=cfg)))
    for key in keys:
        b = {k: np.asarray(v) for k, v in fn(random.split(key, batch)).items()}
        b["images"] = np.asarray(JP.imagenet_normalize(JP.extract_channels(b["waterfall"])))
        yield b


def score(trainer, batches, score_thresh):
    from rfi_toolbox_tpu_torch.evaluation import match_instances

    tp = n_gt = n_det = 0
    fam_tp, fam_n = {}, {}
    for b in batches:
        dets = trainer.predict(b["images"], score_thresh=score_thresh)
        for i, det in enumerate(dets):
            v = b["inst_valid"][i]
            r = match_instances(det, b["inst_masks"][i], b["inst_classes"][i], v,
                                score_thresh=score_thresh)
            tp, n_gt, n_det = tp + r["tp"], n_gt + r["n_gt"], n_det + r["n_det"]
            for c, m in zip(b["inst_classes"][i][v], r["matched"][v]):
                fam_n[int(c)] = fam_n.get(int(c), 0) + 1
                fam_tp[int(c)] = fam_tp.get(int(c), 0) + int(m)
    return {"recall": tp / n_gt, "precision": tp / n_det, "n_gt": n_gt,
            "per_class_recall": {c: fam_tp[c] / fam_n[c] for c in sorted(fam_n)}}


def report(what, q):
    fams = ", ".join(f"{c} {r:.3f}" for c, r in q["per_class_recall"].items())
    print(f"{what}: recall {q['recall']:.4f}, precision {q['precision']:.4f}, n_gt "
          f"{q['n_gt']}; per family {fams}", flush=True)


def bf16_pass_convs():
    """Round every conv's input and weight to bfloat16 (sums stay float32)."""
    from rfi_toolbox_tpu_torch.models import unet

    def forward(self, x):
        def r(t):
            return t.to(torch.bfloat16).to(torch.float32)
        return self._conv_forward(r(x), r(self.weight), self.bias)

    unet.Conv2d.forward = forward


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--mix", choices=sorted(MIXES), default="all6")
    ap.add_argument("--seed", type=int, default=777, help="first key of JAX's stream")
    ap.add_argument("--port-seed", type=int, default=30_000,
                    help="evaluate_instance_model's seed for the port's stream")
    ap.add_argument("--jax-gates", action="store_true")
    ap.add_argument("--bf16-pass", action="store_true")
    args = ap.parse_args(argv)
    from jax import random

    from rfi_toolbox_tpu_torch.evaluation import evaluate_instance_model
    from rfi_toolbox_tpu_torch.train import InstanceTrainer

    if args.bf16_pass:
        bf16_pass_convs()
    numerics = "bf16-pass convs" if args.bf16_pass else "float32"
    if args.jax_gates:
        for mix, batch, n in (("default", 8, 16), ("all6", 16, 64)):
            cfg, thresh = MIXES[mix]
            keys, key = [], random.key(10_000)
            for _ in range(n // batch):  # evaluate_instance_model's key stream
                key, k = random.split(key)
                keys.append(k)
            trainer = InstanceTrainer.load(SNAPSHOT, batch_size=batch, device="cpu")
            report(f"the JAX gate's {n} images, {mix} mix at score {thresh}, {numerics} on "
                   f"the CPU", score(trainer, jax_batches(cfg, keys, batch), thresh))
        return
    cfg, thresh = MIXES[args.mix]
    trainer = InstanceTrainer.load(SNAPSHOT, batch_size=32, rfi_config=cfg, device="cpu")
    keys = [random.key(args.seed + j) for j in range(args.images // 32)]
    head = f"{args.mix} mix at score {thresh}, {args.images} images"
    report(f"{head} of JAX's stream, {numerics} on the CPU",
           score(trainer, jax_batches(cfg, keys, 32), thresh))
    report(f"{head} of the port's stream, {numerics} on the CPU", evaluate_instance_model(
        trainer, num_images=args.images, seed=args.port_seed, score_thresh=thresh))


if __name__ == "__main__":
    torch.set_num_threads(8)
    main()
