"""The single-step learner on the PyTorch port (``orbit_tpu_torch``).

Same flags as ``single-step-learner.py`` (``orbit_tpu.utils.args``); only
``--mode test`` with the ViT backbones and the ``proto``/``proto_cosine``
heads is ported so far, e.g.::

    python single_step_learner_torch.py --data_path <orbit root> --mode test \\
        --feature_extractor vit_b_32 --classifier proto --compute_dtype bfloat16

On a CUDA device the encoder layers run the port's CUDA kernels; on the CPU
they take the kernels' plain PyTorch versions.
"""
from orbit_tpu.utils.args import parse_args
from orbit_tpu_torch.learners.single_step import SingleStepLearner


def main(argv=None):
    SingleStepLearner(parse_args("single-step-learner", argv)).run()


if __name__ == "__main__":
    main()
