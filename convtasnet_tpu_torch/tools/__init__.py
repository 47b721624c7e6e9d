"""Stage 0: the P.56 level meter, the mixture generator and WSJ0
preparation."""
