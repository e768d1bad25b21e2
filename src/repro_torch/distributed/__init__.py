# Distribution layer: fault tolerance, the sharding context, the compressed
# collectives and DiLoCo over a mesh whose members share one device (meshes
# over distinct devices: ROADMAP.md Queue 1 item 11c).
