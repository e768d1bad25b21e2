# Distribution layer: fault tolerance with the elastic restart onto a mesh,
# the sharding context and placement, the compressed collectives and DiLoCo,
# on meshes whose members share one device (meshes over distinct devices:
# ROADMAP.md Queue 1 item 11c).
