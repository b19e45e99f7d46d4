"""Multi-process rendering and training over ``torch.distributed`` (counterpart
of ``raytracer_tpu/parallel/``): pixels strided over the ranks of a mesh axis
(``shard``), triangle geometry split over another (``scene_shard``)."""
