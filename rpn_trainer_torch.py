"""Trainer CLI of the PyTorch port, beside ``rpn_trainer.py``.

    python rpn_trainer_torch.py --backbone vgg16 \
        [--dataset synthetic|/path/to/VOC2007|instances.json] [--device cpu]

Trains on one device (cuda unless ``--device`` says otherwise): the step
(preprocess -> targets with the CUDA target kernel -> forward / backward ->
SGD) runs on the device, batches come from a background prefetcher, and the
best checkpoint by validation loss is saved as a directory of the full train
state. Implementation: :func:`tpurpn_torch.cli.trainer_main`.
"""

from tpurpn_torch.cli import trainer_main as main

if __name__ == "__main__":
    main()
