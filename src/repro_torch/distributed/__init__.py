# Distribution layer: fault tolerance with the elastic restart onto a mesh,
# the sharding context and placement, the compressed collectives and DiLoCo,
# on meshes whose members share one device and, one process a member, on
# meshes over a world's ranks; and a mesh member's own program and its
# collectives over a process group (spmd).
