# Distribution layer: fault tolerance, the mesh-free sharding context and the
# single-device gradient wire (meshes and collectives: ROADMAP.md Queue 1 item 11).
