"""The sklearn ``MLPClassifier`` warm-start limitation demo
(``fedtpu.parity``), over the port's own numpy ``MLPClassifier``."""
