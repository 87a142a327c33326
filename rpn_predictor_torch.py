"""Predictor CLI of the PyTorch port, beside ``rpn_predictor.py``.

    python rpn_predictor_torch.py --backbone mobilenet_v2 \
        --weights trained/rpn_mobilenet_v2_trained.npz --fast [--device cpu]

Loads weights (a checkpoint directory of ``rpn_trainer_torch.py``, a Keras
``.h5`` file or its ``.npz`` twin), serves the test split on the device
(cuda unless ``--device`` says otherwise) through forward -> decode -> top-k
-> NMS, prints proposal recall@topn and draws the first image's top
proposals to a PNG. Implementation: :func:`tpurpn_torch.cli.predictor_main`.
"""

from tpurpn_torch.cli import predictor_main as main

if __name__ == "__main__":
    main()
