#!/usr/bin/env python
"""Convert a pinned timm/augreg/open_clip backbone checkpoint, or a full
reference recogniser checkpoint, into a flax msgpack ``.ckpt`` with the
PyTorch port, without JAX or flax (counterpart of
``scripts/convert_checkpoint.py``; same flags, same output, which either
package loads):

    python scripts/convert_checkpoint_torch.py \\
        --feature_extractor efficientnet_b0 \\
        --torch_path tf_efficientnet_b0_aa-827b6e33.pth \\
        --out pretrained/efficientnet_b0.ckpt

then ``--pretrained_extractor_path pretrained/efficientnet_b0.ckpt``. With
``--full_model`` the input is a full reference recogniser checkpoint and the
output the recogniser's variables, for ``--model_path``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbit_tpu_torch.models.convert import (convert_extractor, load_torch_state_dict,
                                            save_converted)
from orbit_tpu_torch.utils.args import FEATURE_EXTRACTORS


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--feature_extractor", required=True, choices=FEATURE_EXTRACTORS)
    p.add_argument("--torch_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--full_model", action="store_true",
                   help="Input is a full reference recogniser checkpoint "
                        "(e.g. the published protonets_*.pt) rather than a "
                        "bare timm backbone; emits variables loadable with "
                        "--model_path.")
    p.add_argument("--classifier", default="proto",
                   choices=["linear", "versa", "proto", "proto_cosine", "mahalanobis"],
                   help="(--full_model) classifier the checkpoint was trained with.")
    p.add_argument("--adapt_features", action="store_true",
                   help="(--full_model) checkpoint includes FiLM generator + set encoder.")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    sd = load_torch_state_dict(args.torch_path)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.full_model:
        from orbit_tpu_torch.models.convert import convert_recogniser_checkpoint
        from orbit_tpu_torch.models.recognisers import (MultiStepFewShotRecogniser,
                                                        SingleStepFewShotRecogniser)
        from orbit_tpu_torch.utils.checkpoint import save_checkpoint

        cls = (MultiStepFewShotRecogniser if args.classifier == "linear"
               else SingleStepFewShotRecogniser)
        rec = cls(feature_extractor_name=args.feature_extractor,
                  adapt_features=args.adapt_features, classifier=args.classifier).init(0)
        save_checkpoint(args.out, convert_recogniser_checkpoint(sd, rec))
    else:
        params, batch_stats = convert_extractor(sd, args.feature_extractor)
        save_converted(args.out, params, batch_stats)
    print(f"converted {len(sd)} tensors -> {args.out}")


if __name__ == "__main__":
    main()
