"""kv.gather_live (%): the share of the KV page slots the decode step
gathers that hold live pages, over the window: the pages each running
request held at each step (the serving engine's ``page_slot_steps``)
over the page-table slots its attention gathered
(``gathered_page_steps``; the whole table, live or not, while the
gather is not narrowed).  Moves ``out_tok_s``."""


def read(run):
    live, gathered = (run.stats["page_slot_steps"],
                      run.stats.get("gathered_page_steps"))
    return 100.0 * live / gathered if gathered else None
