"""The multi-step learner (FineTuner) on the PyTorch port (``orbit_tpu_torch``).

Same flags as ``multi-step-learner.py`` (``orbit_tpu_torch.utils.args``,
with the ``--personalize_*`` group), test mode only, on every backbone,
with a frozen extractor or with FiLM, e.g.::

    python multi_step_learner_torch.py --data_path <orbit root> --mode test \\
        --feature_extractor efficientnet_b0 --classifier linear \\
        --compute_dtype bfloat16 --batch_size 256 --frame_size 224

    python multi_step_learner_torch.py --data_path <orbit root> --mode test \\
        --feature_extractor vit_b_32_clip --adapt_features --classifier linear \\
        --compute_dtype bfloat16 --batch_size 256

It runs on ``cuda:<--gpu>``, where the backbones run the port's CUDA
kernels, and raises without a card. ``main(argv, device="cpu")`` runs it on
the CPU with the kernels' plain PyTorch versions (the tests do).
"""
from orbit_tpu_torch.learners.multi_step import MultiStepLearner
from orbit_tpu_torch.utils.args import parse_args


def main(argv=None, device=None):
    MultiStepLearner(parse_args("multi-step-learner", argv), device=device).run()


if __name__ == "__main__":
    main()
