"""Serving workload of the port: model core (``train``), weight forms
(``quant``), decode helpers (``decode``), paged KV memory and the paged
attention kernel's wrapper (``paged_kv``), the continuous engine
(``continuous``) and its HTTP front end (``serve``)."""
