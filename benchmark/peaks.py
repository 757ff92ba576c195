"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full power limit of 700 W; a card set below it runs slower, so every
run prints the card's limit beside its numbers)."""

HBM_BYTES_PER_S = 3.35e12           # 80 GB of HBM3
