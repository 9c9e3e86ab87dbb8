"""PyTorch + CUDA port of the batched Filter/Score/assign scheduler.

The port runs the batch solve (greedy scan, wavefront, auction), its
resident caches, the extender's single-pod evaluation and preemption on
an NVIDIA Hopper card through hand-written CUDA kernels (csrc/), with a
plain-torch version of every device function beside each kernel.  Entry points run on the card
unless the caller asks for the CPU (``device="cpu"``), where the plain
versions run.
"""
