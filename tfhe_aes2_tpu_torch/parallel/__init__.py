"""Scale-out layer: device meshes, sharded CTR batches and PBS lanes, and
multi-process runs over torch.distributed.

CTR blocks (independent) split over a mesh 'block' axis; within a block the
16 bytes x 8 bits of circuit bootstraps split over a 'lane' axis; evaluation
keys are replicated, so the blind rotations need no communication
(mesh.py). Across processes the same layouts run with torch.distributed
(distributed.py); gate.py is the standing multi-process check.
"""

from tfhe_aes2_tpu_torch.parallel.mesh import (
    Mesh, block_spec, make_mesh, make_sharded_encrypt_blocks_fn,
    make_sharded_full_aes_fn)
