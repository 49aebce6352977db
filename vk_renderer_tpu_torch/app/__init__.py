"""Entry points: the headless CLI renderer."""
