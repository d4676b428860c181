"""Configuration presets and parameter / FLOP reporting of the port."""
