from .mesh import (Mesh, ShardingPlan, init_ranks, make_mesh,  # noqa: F401
                   make_plan, mesh_from_config)
