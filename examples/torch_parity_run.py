"""Fixed-seed parity run of the PyTorch port against a real checkpoint (BASELINE.json config #1).

Given a local diffusers-layout checkpoint directory, runs the SD-1.5 512px
AID fused_outer 3-frame ``interpolate_single`` at 25 steps and writes the
frames plus JSON stats for an offline comparison with the reference (see
PARITY.md). The reference's exported latents and prompt embeddings
(``--latent-start`` ..., read by ``aid_tpu_torch.utils.parity``) make both
programs denoise the same starting state; the embeddings bypass the
tokenizer and the text encoder, so the comparison isolates the UNet and
the scheduler. SDXL checkpoints are told by their second text encoder;
``--sdxl`` asserts it and the pooled embeddings complete the bypass.

Usage:
    python examples/torch_parity_run.py --checkpoint /path/to/sd15 \
        [--latent-start start.npy --latent-end end.npy] [--embeds-start e0.npy --embeds-end e1.npy \
        --neg-embeds neg.npy] [--steps 25] [--out out/parity] [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True, help="diffusers-layout checkpoint directory")
    ap.add_argument("--latent-start", default=None, help="reference-exported latents (.npy/.npz/.pt/.safetensors)")
    ap.add_argument("--latent-end", default=None)
    ap.add_argument("--embeds-start", default=None,
                    help="reference-exported cond text embeds (1, 77, D); with --embeds-end and --neg-embeds")
    ap.add_argument("--embeds-end", default=None)
    ap.add_argument("--neg-embeds", default=None)
    ap.add_argument("--guide-embeds", default=None, help="optional PAID guide embeds")
    ap.add_argument("--sdxl", action="store_true", help="assert an SDXL checkpoint; enables the pooled-embeds args")
    ap.add_argument("--pooled-embeds-start", default=None, help="SDXL pooled cond embeds (1, 1280)")
    ap.add_argument("--pooled-embeds-end", default=None)
    ap.add_argument("--neg-pooled-embeds", default=None)
    ap.add_argument("--guide-pooled-embeds", default=None)
    ap.add_argument("--prompt-start", default="A photo of dog, best quality, extremely detailed")
    ap.add_argument("--prompt-end", default="A photo of car, best quality, extremely detailed")
    ap.add_argument("--it", type=float, default=0.5)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--warmup-ratio", type=float, default=0.5)
    ap.add_argument("--guidance", type=float, default=None, help="default: the family default (SD 7.5, SDXL 5.0)")
    ap.add_argument("--scheduler", default="auto",
                    help="'auto' (default): the checkpoint's scheduler class, as the reference's from_pretrained")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (f32, the plain versions)")
    ap.add_argument("--out", default="out/parity")
    return ap


def bypass_kwargs(args, is_xl: bool, device) -> dict:
    """The exported latents and embeddings the arguments name, read onto
    ``device``, as ``interpolate_single`` keywords."""
    from aid_tpu_torch.utils.parity import load_reference_embeds, load_reference_latents

    kw = {}
    if args.latent_start:
        kw["latent_start"] = load_reference_latents(args.latent_start, device=device)
        kw["latent_end"] = load_reference_latents(args.latent_end, device=device)
    if not args.embeds_start:
        return kw
    if not (args.embeds_end and args.neg_embeds):
        raise SystemExit("--embeds-start needs --embeds-end and --neg-embeds")
    names = {"prompt_embeds_start": args.embeds_start, "prompt_embeds_end": args.embeds_end,
             "negative_prompt_embeds": args.neg_embeds, "guide_prompt_embeds": args.guide_embeds}
    if is_xl:
        if not (args.pooled_embeds_start and args.pooled_embeds_end and args.neg_pooled_embeds):
            raise SystemExit("the SDXL embeds bypass needs --pooled-embeds-start/end and --neg-pooled-embeds")
        names.update(pooled_prompt_embeds_start=args.pooled_embeds_start,
                     pooled_prompt_embeds_end=args.pooled_embeds_end,
                     negative_pooled_prompt_embeds=args.neg_pooled_embeds,
                     guide_pooled_prompt_embeds=args.guide_pooled_embeds)
    kw.update({k: load_reference_embeds(path, device=device) for k, path in names.items() if path})
    return kw


def main(argv=None):
    import torch

    from aid_tpu_torch.models.loader import load_interpolation_pipeline
    from aid_tpu_torch.utils.images import save_image, show_images_horizontally
    from aid_tpu_torch.utils.parity import image_stats

    args = parser().parse_args(argv)
    place = dict(device="cpu", dtype=torch.float32) if args.device == "cpu" else dict(device=args.device)
    pipe = load_interpolation_pipeline(args.checkpoint, scheduler_name=args.scheduler, guidance_scale=args.guidance,
                                       **place)
    is_xl = getattr(pipe, "text_encoder_2", None) is not None
    if args.sdxl and not is_xl:
        raise SystemExit("--sdxl given but the checkpoint loaded as SD (no text_encoder_2)")
    images = pipe.interpolate_single(
        args.it, prompt_start=args.prompt_start, prompt_end=args.prompt_end, num_inference_steps=args.steps,
        warmup_ratio=args.warmup_ratio, early="fused_outer", late="self", seed=args.seed,
        **bypass_kwargs(args, is_xl, pipe.device))

    os.makedirs(args.out, exist_ok=True)
    show_images_horizontally(images, os.path.join(args.out, "frames.png"))
    for i, frame in enumerate(images):
        save_image(frame, os.path.join(args.out, f"frame_{i}.png"))
    stats = image_stats(images)
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps({k: v for k, v in stats.items() if k != "corner_patches"}))


if __name__ == "__main__":
    main()
