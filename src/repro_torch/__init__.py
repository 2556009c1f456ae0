"""repro_torch — the PyTorch/CUDA port of the geometric task mapper.

Same layout as the reference package ``repro`` (``core``, ``mapping``,
``serve``, ``kernels``, ``obs``, ``faults``), PyTorch idiom inside:
plain functions on tensors, an explicit ``device`` argument, every
tensor's dtype stated.  The port imports ``torch`` and ``numpy`` and
nothing of the reference package.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
nothing falls back from a device or a kernel that cannot run.
"""
