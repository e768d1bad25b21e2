# Distribution layer: fault tolerance with the elastic restart onto a mesh,
# the sharding context and placement, the compressed collectives and DiLoCo,
# on meshes whose members share one device (those paths over distinct
# devices: ROADMAP.md Queue 1 item 11c); and a mesh member's own program
# and its collectives over a process group (spmd).
