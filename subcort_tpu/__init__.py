"""subcort_tpu — sub-cortical brain-structure segmentation framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
sergivalverde/sub-cortical_segmentation (voxelwise 15-class sub-cortical
segmentation of T1-w MRI; arXiv:1709.09075). The compute path is
JAX/XLA on an NVIDIA GPU; the registration runtime is native C++
(see ``native/``). Nothing here is a translation of the reference's
Theano/Lasagne code — the architecture is volume-resident and
gather/scatter based rather than host-side patch-list based.

Public API (mirrors the reference's layer map, SURVEY.md §1):

- Config system (L1):   :mod:`subcort_tpu.config`
- Registration  (L2):   :mod:`subcort_tpu.registration`
- Data engine   (L3):   :mod:`subcort_tpu.ops`, :mod:`subcort_tpu.engine.data`
- Model/training(L4):   :mod:`subcort_tpu.models`, :mod:`subcort_tpu.engine.train`
- Workload API  (L5):   :mod:`subcort_tpu.engine`
- CLI driver    (L6):   :mod:`subcort_tpu.cli`
"""

__version__ = "0.1.0"

from subcort_tpu.config import Options, load_options, print_options  # noqa: F401
