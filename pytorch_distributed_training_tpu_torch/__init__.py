"""PyTorch/CUDA port of ``pytorch_distributed_training_tpu``.

The JAX package beside this one is the reference; this package keeps its
layout (``utils/``, ``data/``, ``ops/``, ``models/``, ``train/``,
``comms/``, ``serve/``, ``cli/``) so every module has a counterpart of the
same name there. It imports
``torch`` and numpy only: never JAX, and nothing of the JAX package.

Kernels are hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use (``ops/_build.py``). Every kernel wrapper keeps a
plain PyTorch version beside it, which runs when the tensors lie on the
CPU; on a CUDA tensor the wrapper launches the kernel or raises.

Ported so far: the paged serving path of ``cli/serve_lm.py`` for the
GPT-2 family, and data-parallel BERT fine-tuning through
``cli/train_dp.py`` (see ROADMAP.md for what is still to come).
"""
