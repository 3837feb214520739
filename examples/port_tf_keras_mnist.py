"""TF/Keras MNIST on the PyTorch/CUDA port's runtime: the reference's
``examples/tensorflow2/tensorflow2_keras_mnist.py`` workflow through
``horovod_tpu_torch.tensorflow.keras``.

Keras computes on the CPU; the port's runtime carries the collectives
(NCCL on the card, Gloo with ``--platform cpu``).  The learning rate is
scaled by the world size with a warm-up, the optimizer averages its
gradients across ranks, the weights are broadcast from rank 0 when
training begins and the epoch's metrics averaged at its end.  The data is
synthetic (MNIST-shaped, from each rank's own seed).  Needs TensorFlow and
Keras.

    python -m horovod_tpu_torch.runner -np 2 -- \\
        python examples/port_tf_keras_mnist.py
    (add --platform cpu to both without a card)
"""

import argparse
import os

import numpy as np


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", choices=("gpu", "cpu"), default=None,
                   help="the runtime's platform (default: the card)")
    p.add_argument("--samples", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=2)
    args = p.parse_args()
    if args.platform:
        os.environ["HVDTPU_PLATFORM"] = args.platform

    import keras
    import horovod_tpu_torch.tensorflow.keras as hvd

    hvd.init()
    rng = np.random.RandomState(hvd.rank())
    x = rng.rand(args.samples, 28, 28, 1).astype("float32")
    y = rng.randint(0, 10, size=(args.samples,))

    keras.utils.set_random_seed(42 + hvd.rank())   # the broadcast syncs it
    model = keras.Sequential([
        keras.layers.Input((28, 28, 1)),
        keras.layers.Conv2D(16, 3, activation="relu"),
        keras.layers.MaxPooling2D(),
        keras.layers.Flatten(),
        keras.layers.Dense(64, activation="relu"),
        keras.layers.Dense(10),
    ])
    scaled_lr = 0.001 * hvd.size()
    model.compile(
        optimizer=hvd.DistributedOptimizer(
            keras.optimizers.Adam(learning_rate=scaled_lr)),
        loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"])
    steps = max(1, args.samples // args.batch_size)
    hist = model.fit(
        x, y, batch_size=args.batch_size, epochs=args.epochs, verbose=0,
        callbacks=[
            hvd.callbacks.BroadcastGlobalVariablesCallback(0),
            hvd.callbacks.MetricAverageCallback(),
            hvd.callbacks.LearningRateWarmupCallback(
                initial_lr=scaled_lr, warmup_epochs=1,
                steps_per_epoch=steps),
        ])
    losses = hist.history["loss"]
    if hvd.rank() == 0:
        print(f"DONE tf_keras_mnist first={losses[0]:.4f} "
              f"last={losses[-1]:.4f} size={hvd.size()}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
