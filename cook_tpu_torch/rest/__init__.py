"""The port's part of ``cook_tpu/rest``: the request observer
(``instrument``) alone.  The API, its server and its clients wait for
ROADMAP queue 1, item 10."""
