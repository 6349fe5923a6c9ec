"""Multi-device helpers: the mesh, the data-parallel embed, the sharded
gallery searches.

Counterpart of `facerecognitionpipeline_tpu/parallel`. One process drives
a `Mesh` of devices:

* data parallel: frames or faces split over the 'data' axis, one weight
  replica per device (`data_parallel_embed`, the engine's `mesh=`);
* gallery sharding: `gallery.search.sharded_cosine_topk` (gallery rows
  split over an axis, queries replicated) and `dp_sharded_cosine_topk`
  (rows and the query batch over the same 'data' axis, the engine's
  `shard_gallery=True`);
* training: data parallel x the class-sharded classifier over 'model'
  (`train/trainer.py`).

The two searches are imported from `gallery.search` on first use (that
module imports this package's mesh).
"""

from facerecognitionpipeline_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_parallel_embed,
    make_mesh,
)

_LAZY = ("dp_sharded_cosine_topk", "sharded_cosine_topk")


def __getattr__(name):
    if name in _LAZY:
        from facerecognitionpipeline_tpu_torch.gallery import search

        return getattr(search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
