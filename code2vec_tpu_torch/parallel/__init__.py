"""Training and evaluation over a (data, model) mesh of ranks:
``distributed.py`` joins the world, ``mesh.py`` lays it out."""
