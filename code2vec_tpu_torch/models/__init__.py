"""Model math (``functional``) and the module holding the weights
(``backends``)."""
