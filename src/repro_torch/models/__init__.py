"""The LM stack: layers, GQA attention, MoE, the recurrent mixers, the
decoder, and the sharding rules over a mesh."""
