#!/usr/bin/env python
"""Port the source workload's torch checkpoint into this image's trainer.

Generated by move2kube-tpu (cuda emitter). Converts a HuggingFace or
torchvision ``state_dict`` into the vendored PyTorch model's state dict
and writes it as the trainer's step-0 checkpoint (a params-only tree) —
the training entrypoint (train_gpu.py) then starts from it, so a
fine-tune continues from the same weights it used before.

Usage (inside the image, or any machine with torch installed):

    python port_weights.py <checkpoint.pt-or-.bin-or-dir> <ckpt_dir>

then launch training with M2KT_CKPT_DIR=<ckpt_dir>. Accepts a torch saved
state_dict, a full torch checkpoint dict with a ``state_dict``/``model``
key, or a directory containing ``pytorch_model.bin``.

The model family is baked in at translation time (``FAMILY`` below).
"""

import os
import sys

# m2kt:baked-begin (the emitter rewrites these lines)
FAMILY = "llama"
# m2kt:baked-end


def load_state_dict(path):
    import torch

    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.pt", "checkpoint.pt"):
            candidate = os.path.join(path, name)
            if os.path.isfile(candidate):
                path = candidate
                break
        else:
            raise SystemExit(f"no torch checkpoint found under {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "module"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k: v for k, v in obj.items() if hasattr(v, "shape") or hasattr(v, "numpy")}


def main():
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    src, ckpt_dir = sys.argv[1], sys.argv[2]
    sd = load_state_dict(src)

    from move2kube_tpu_torch.models import convert as m2kt_convert

    family = FAMILY
    batch_stats = None
    if family == "resnet":
        params, batch_stats = m2kt_convert.resnet_params_from_torch(sd)
    elif family == "bert":
        params = m2kt_convert.bert_params_from_torch(
            sd, num_layers=m2kt_convert.infer_num_layers(sd, family))
    elif family == "gpt2":
        params = m2kt_convert.gpt2_params_from_torch(
            sd, num_layers=m2kt_convert.infer_num_layers(sd, family))
    elif family in ("llama", "gpt"):
        params = m2kt_convert.llama_params_from_torch(
            sd, num_layers=m2kt_convert.infer_num_layers(sd, family))
    elif family == "unet":
        raise SystemExit(
            "automatic checkpoint porting is not supported for diffusion "
            "UNets: upstream layouts vary too much across diffusers/"
            "CompVis/custom DDPM repos to map mechanically. The emitted "
            "trainer trains the DDPM UNet from scratch; to resume from a "
            "GPU checkpoint, write a mapping onto the state dict of "
            "move2kube_tpu_torch/models/unet.py (names match the module "
            "structure) and save it with models/checkpoint.py.")
    else:
        raise SystemExit(f"no converter for model family {family!r}")

    from move2kube_tpu_torch.models import checkpoint as m2kt_ckpt

    # the BatchNorm statistics are the ResNet's buffers: one state dict
    tree = dict(params)
    if batch_stats is not None:
        tree.update(batch_stats)
    mngr = m2kt_ckpt.CheckpointManager(ckpt_dir, every=1)
    mngr.maybe_save(0, {"params": tree}, force=True)
    mngr.close()
    print(f"[m2kt] ported {len(tree)} arrays -> {ckpt_dir} (step 0); "
          f"run training with M2KT_CKPT_DIR={ckpt_dir}")


if __name__ == "__main__":
    main()
