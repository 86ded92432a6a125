from .mesh import (DATA_AXIS, EXPERT_AXIS, MESH_AXES, MODEL_AXIS, PIPE_AXIS,
                   SEQ_AXIS, ZERO_AXES, MeshContext, MeshShape,
                   get_mesh_context, initialize_mesh, reset_mesh_context,
                   resolve_mesh_shape, set_mesh_context)
from . import groups
