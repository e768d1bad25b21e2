"""Model stack: layers, GQA attention and the decoder LM (dense attention
families; MoE and the recurrent mixers: ROADMAP.md Queue 1 item 12b)."""
