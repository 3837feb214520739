"""Models of the port, the five configurations BASELINE.json names:

- ``mnist.ConvNet`` (config 1);
- ``resnet.resnet50`` and ``resnet18_thin`` (config 2, with flax's batch
  norm, synchronized over a process group when given one);
- ``bert.Bert`` at ``BertConfig.bert_large()`` (config 3, MLM);
- ``llama`` (config 4: training, generation and serving, dense and MoE,
  on meshes and pipelines);
- ``dlrm`` (config 5: the dense half and the tables' two-exchange lookup
  over a process group).

Each module keeps the JAX package's input layouts and numerics, and its
``params_from_jax`` carries the JAX package's variables across, so the
tests hold the two packages against each other on the same weights.
None of the four smaller models reaches a hand-written kernel: the JAX
package computes them with XLA's convolutions, products and gathers,
and the port with PyTorch's.  The modules are imported by name
(``from horovod_tpu_torch.models import resnet``).
"""
