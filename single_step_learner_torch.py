"""The single-step learner on the PyTorch port (``orbit_tpu_torch``).

Same flags as ``single-step-learner.py`` (``orbit_tpu_torch.utils.args``);
the ViT backbones with the ``proto``/``proto_cosine`` heads are ported, in
every mode, e.g.::

    python single_step_learner_torch.py --data_path <orbit root> --mode train_test \\
        --feature_extractor vit_b_32 --classifier proto --compute_dtype bfloat16 \\
        --with_lite --learn_extractor --num_lite_samples 16 --batch_size 256

It runs on ``cuda:<--gpu>``, where the encoder layers run the port's CUDA
kernels, and raises without a card. ``main(argv, device="cpu")`` runs it
on the CPU with the kernels' plain PyTorch versions (the tests do).
"""
from orbit_tpu_torch.learners.single_step import SingleStepLearner
from orbit_tpu_torch.utils.args import parse_args


def main(argv=None, device=None):
    SingleStepLearner(parse_args("single-step-learner", argv), device=device).run()


if __name__ == "__main__":
    main()
