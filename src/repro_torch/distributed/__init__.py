# Distribution layer: fault tolerance (sharding and collectives: ROADMAP.md Queue 1 item 11).
