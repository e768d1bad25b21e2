"""Model stack: layers, GQA attention, the MoE and recurrent mixers, and
the decoder LM for every registered family."""
