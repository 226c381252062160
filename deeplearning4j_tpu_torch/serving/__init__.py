"""Serving on the card: the continuous decode scheduler
(``serving/continuous.py``). The router, fleet and prefix cache of the
reference's serving tier wait for ROADMAP A10 and A11."""
