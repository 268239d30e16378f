"""hashreadmapper_tpu: a JAX bisulfite (BS-seq) read mapper for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the CUDA
reference `clubby93421234/hashreadmapper` (see SURVEY.md).  The package
keeps the name of the accelerator it was first written for.
"""

__version__ = "0.1.0"
