"""``python -m mudiff_torch.cli.metric_calc``: offline metrics of pred/ vs
gt/ PNG directories (the counterpart of ``mudiff_tpu/cli/metric_calc.py``;
reference tools/metric_calc.py).

    python -m mudiff_torch.cli.metric_calc --pred_dir P --gt_dir G \\
        [--lpips_alexnet ALEX.pth [--lpips_lin LIN.pth] | --lpips_rand]

PSNR, SSIM and MAE (and their standard deviations) over the matching
pairs on [0, 1] grayscale, printed as JSON.  LPIPS is added with the
weights' paths (key ``lpips``) or with ``--lpips_rand``, the JAX
package's fixed random AlexNet (key ``lpips_rand``, not LPIPS): flags in
place of the JAX package's ``MUDIFF_LPIPS_*`` variables.  LPIPS runs on
the card unless the caller asks for the CPU.
"""

import argparse
import json
from typing import Optional

from mudiff_torch.metrics import evaluate_pair_dirs
from mudiff_torch.sampler import serving_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("mudiff_torch metric_calc")
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--lpips_alexnet", default=None,
                    help="torchvision alexnet state dict, or a whole lpips.LPIPS one")
    ap.add_argument("--lpips_lin", default=None, help="the lpips package's alex.pth")
    ap.add_argument("--lpips_rand", action="store_true",
                    help="the random-feature proxy, reported as lpips_rand")
    return ap


def scorer(alexnet: Optional[str], lin: Optional[str], rand: bool, device=None):
    """The LPIPS scorer the flags ask for, or None."""
    if not (alexnet or rand):
        return None
    from mudiff_torch.metrics.lpips import LPIPS, load_torch_weights, random_params

    device = serving_device(device, "metric_calc (LPIPS)")
    if alexnet:
        return LPIPS(load_torch_weights(alexnet, lin), device=device)
    return LPIPS(random_params(0), is_random=True, device=device)


def main(argv=None, device=None) -> dict:
    """Run the CLI; ``device`` (default the card) is for the tests only.
    Returns the printed metrics."""
    args = build_parser().parse_args(argv)
    if args.lpips_alexnet and args.lpips_rand:
        raise SystemExit("--lpips_alexnet and --lpips_rand exclude each other")
    fn = scorer(args.lpips_alexnet, args.lpips_lin, args.lpips_rand, device)
    metrics = evaluate_pair_dirs(args.pred_dir, args.gt_dir, lpips_fn=fn)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
