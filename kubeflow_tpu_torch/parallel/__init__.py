"""Device meshes (the port of `kubeflow_tpu/parallel/`, so far the part the
ring attention op uses)."""

from kubeflow_tpu_torch.parallel.mesh import Mesh, current_mesh

__all__ = ["Mesh", "current_mesh"]
