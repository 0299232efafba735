"""English text → IPA phonemes.

Pipeline mirrors the reference (utils/g2p/english.py:159-188): ascii-fold →
lowercase → abbreviation expansion → number normalization → per-word G2P →
ipa2 post-pass (r→ɹ, ʤ→dʒ, ʧ→tʃ, dark-l marking, '...'→'…').

The reference delegates word G2P to the `eng_to_ipa` package (a CMUdict
lookup). That data is unavailable in this image, so we embed a lexicon for
frequent words (lexicon_en.py) and fall back to rule-based letter-to-sound
for OOV words. The output IPA conventions match the trained vocabulary.
"""

from __future__ import annotations

import re
import unicodedata

from .lexicon_en import LEXICON
from .numbers_en import normalize_numbers

# --- abbreviations (reference: utils/g2p/english.py:31-50) -----------------
_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]

VOWELS_IPA = "ɑæɔəɛɪʊaeiou"

# ---------------------------------------------------------------------------
# Rule-based letter-to-sound for OOV words.
#
# Rules are (grapheme, left-context regex, right-context regex, ipa) tried in
# order at each position; the longest/earliest match wins. Contexts are
# regexes anchored at the boundary. Output uses pre-ipa2 conventions
# ('r', 'ʧ', 'ʤ') so the shared post-pass applies uniformly.
# ---------------------------------------------------------------------------

V = "[aeiouy]"  # orthographic vowels
C = "[bcdfghjklmnpqrstvwxz]"

# fmt: off
_LTS_RULES = [
    # --- round-7 confusion-mined rules (each batch measured on the full
    # lexicon before landing; combined: PER 13.64→13.17 %, exact
    # 55.1→56.7 %). Specific graphemes go first so they shadow the
    # generic single-letter rules below at the same position. ---
    # Greek-origin ch → k (echo, technology, mechanic, orchestra,
    # character, chronic, chemistry, chorus, psychology)
    ("ech", None, "(?=[ona])", "ɛk"),
    ("orch", None, "(?=[ei])", "ɔrk"),
    ("charac", None, None, "kɛrək"),
    ("chron", None, None, "krɑn"),
    ("chem", None, None, "kɛm"),
    ("chor", None, "(?=us|al|d)", "kɔr"),
    ("psych", None, None, "saɪk"),
    # silent h (honor, honest, heir, herb — American —, rhythm, exhaust)
    ("hono", "^", None, "ɑnə"),
    ("hones", "^", None, "ɑnəs"),
    ("heir", "^", None, "ɛr"),
    ("herb", "^", None, "ərb"),
    ("rh", "^", None, "r"),
    ("exhau", "^", None, "ɪgzɔ"),
    ("exhi", "^", None, "ɪgzɪ"),
    # yod-ful cu/gu/pu/mu: the u spells ju, reduced to jə when the
    # following suffix is unstressed (circular, calculate, document,
    # occupy, regular, popular, formula) and kept full before magic-e
    # or a following r-vowel (cute, excuse, prosecutor, secure, curious)
    ("cu", None, "(?=la[rt]|lati|men|mul|pie|py$|tive)", "kjə"),
    ("cu", None, "(?=te$|tes$|ted$|tor|se$|ses$|sed$)", "kju"),
    ("cu", None, "(?=r[aeiouy](?!r))", "kjʊ"),
    ("cue", None, "s?$", "kju"),      # cue, rescue, barbecue
    ("cu", None, "(?=tio)", "kju"),   # execution
    ("ccu", None, "(?=mul)", "kju"),  # accumulate (cc collapse shadows cu)
    ("cu", None, "(?=[bcd][aeiouy])", "kju"),  # cube, cuba, cucumber
    ("fur", None, "(?=[iy])", "fjʊr"),  # fury, furious
    ("bureau", None, None, "bjʊroʊ"),
    ("gu", None, "(?=la[rt])", "gjə"),
    ("pu", None, "(?=la[rt])", "pjə"),
    ("mu", None, "(?=la[rt]|lus)", "mjə"),
    # silent g clusters (campaign, reign, things, sign/design, paradigm)
    ("aign", None, None, "eɪn"),
    ("eign", None, None, "eɪn"),
    ("ngs", None, "$", "ŋz"),
    ("ign", None, "s?$", "aɪn"),
    ("gm", None, "$", "m"),
    # velar nasal before a /k/ cluster (function, distinct, uncle) —
    # lookahead keeps the t for the tion→ʃən rule
    ("nc", None, "(?=t)", "ŋk"),
    ("ncle", None, None, "ŋkəl"),
    # soft sc/xc (scene, descend, except, exceed)
    ("sc", None, "(?=[eiy])", "s"),
    ("xc", None, "(?=[eiy])", "ks"),
    # eer/ear → ɪr (beer, career, year, near — lc excludes bear/wear/
    # pear/linear); college/privilege -ege
    ("eer", None, None, "ɪr"),
    ("ear", "(?:^n|[^bpwln])", "s?$", "ɪr"),
    ("ege", None, "s?$", "ɪʤ"),
    # u in hiatus after l/r/d/t keeps its quality (cruel, influence, dual)
    ("ue", "[lr]", "(?=[a-z])", "uə"),
    ("ua", "[dlrt]", None, "uə"),
    # ow → aʊ in the how/now/cow family (the generic ow rule says oʊ)
    ("how", None, "$", "haʊ"),
    ("now", "^", "$", "naʊ"),
    ("cow", "^", None, "kaʊ"),
    ("ow", "(?:br|pl|v)", "s?$", "aʊ"),
    # yod-glide i before a weak vowel (italian, brilliant, junior)
    ("ia", "l{1,2}", "(?=nt?s?$)", "jə"),
    ("nio", None, "(?=r)", "njə"),
    # unstressed -ward(s)/-ffort/-mfort; for- before give/get/bid
    ("ward", V + "[a-z]*" + C, "s?$", "wərd"),
    ("for", "^", "(?=giv|get|bid)", "fər"),
    ("ffort", None, "s?$", "fərt"),
    ("mfort", None, "s?$", "mfərt"),
    # short ea before voiced stops/fricatives in the ready/heavy/health/
    # measure/pleasant families; death/breath but not beneath/wreath
    ("ealth", None, None, "ɛlθ"),
    ("easant", None, None, "ɛzənt"),
    ("easure", None, None, "ɛʒər"),
    ("eath", "(?:^d|^br)", None, "ɛθ"),
    ("ead", None, "(?=y$|ily|ier)", "ɛd"),
    ("eav", None, "(?=y$|en|il)", "ɛv"),
    # hard g exceptions to the g+e/i → ʤ default (get, forget, give,
    # girl); water/cloth ɔ
    ("get", "(?:^|for)", None, "gɛt"),
    ("girl", None, None, "gərl"),
    ("gi", None, "(?=ve|ving|ven)", "gɪ"),
    ("wat", "^", "(?=er)", "wɔt"),
    ("oth", "(?:cl|br)", "s?$", "ɔθ"),
    # -rival keeps magic-e aɪ (arrival, survival, rival — not trivial:
    # 'rivia' does not match); wor+k/d/l/s/t → wər also word-medially
    # (network, password, homework)
    ("rival", None, None, "raɪvəl"),
    ("wor", None, "(?=[kdlst])", "wər"),
    # unstressed final -lar/-gar/-mar → ər (dollar, similar, regular,
    # sugar, grammar; cigar/radar mispredict but the family wins 5:1)
    ("lar", V + "[a-z]*", "$", "lər"),
    ("gar", V + "[a-z]*", "$", "gər"),
    ("mar", V + "[a-z]*", "$", "mər"),
    # round-8 mined batch (same methodology; 13.15→13.04 % combined):
    # hear/fierce, -orate/-oration medial or→ər (decorate, corporation),
    # thorough/borough, senior/unique, the own/grown long-o family,
    # flour/sour, final -eo and geo- hiatus, -iness
    ("hear", None, None, "hir"),
    ("ierce", None, None, "ɪrs"),
    ("or", None, "(?=ate|atio)", "ər"),
    ("orough", None, None, "əroʊ"),
    ("eni", None, "(?=or)", "inj"),
    ("ique", None, "s?$", "ik"),
    ("own", "(?:^|kn|gr|sh|fl|thr|sl|bl)", None, "oʊn"),
    ("owth", None, None, "oʊθ"),
    ("low", "s", "(?=ly|ing|ed|er|s$|$)", "loʊ"),
    ("our", "(?:^|h|fl|^s)", "s?$", "aʊər"),
    ("eo", V + "[a-z]*" + C, "$", "ioʊ"),
    ("geo", "^", "(?!r)", "ʤiɑ"),
    ("iness", "[^s]", "$", "inəs"),
    # round-9 mined batch (13.04→12.97 %): deadline/headquarters short
    # ea, bear/wear/pear, precious; the knows/showed/owe/bowl/soul
    # long-o family; unstressed -alty/-orary/-nora-/-bor-; comfort;
    # realize hiatus; danger/stranger
    ("ead", None, "(?=li|qu)", "ɛd"),
    ("east", "br", None, "ɛst"),
    ("ear", "(?:^b|^w|^sw|^p)", "s?$", "ɛr"),
    ("ecious", None, None, "ɛʃəs"),
    ("preci", "^", "(?=ou)", "prɛʃ"),  # the pre- prefix rule wins at i=0 otherwise
    ("ows", "(?:kn|sh|gr|thr|fl|bl|sl)", "$", "oʊz"),
    ("owed", "(?:kn|sh|gr|thr|fl|bl|sl)", "$", "oʊd"),
    ("owe", "^", None, "oʊ"),
    ("owl", "b", None, "oʊl"),
    ("ower", "(?:^l|^m)", None, "oʊər"),
    ("oul", "(?:^s|b)", None, "oʊl"),
    ("alty", V + "[a-z]*", "$", "əlti"),
    ("nora", None, None, "nərə"),
    ("bor", V + "[a-z]*", "(?=hood|ing$)", "bər"),
    ("comfor", "^", None, "kʌmfər"),
    ("orary", None, "$", "ərɛri"),
    ("ea", "r", "(?=liz|lis)", "iə"),
    ("anger", "(?:^d|^r|^str)", None, "eɪnʤər"),
    # round-18 batch (10.02→9.91 %): nationality/demonym suffixes
    # (-ssia(n), -sian, -ptian, -stian, -nese), -ington, silent g in
    # ngk, europe
    ("iber", None, None, "aɪbər"),
    ("iver", "(?:dr|f)", None, "aɪvər"),
    ("ycle", None, None, "aɪkəl"),
    ("ital", "^v", None, "aɪtəl"),
    ("iny", "^t", None, "aɪni"),
    ("archive", None, None, "ɑrkaɪv"),
    ("ivers", "d", None, "aɪvərs"),
    ("riteria", None, None, "raɪtɪriə"),
    ("arriv", "^", None, "əraɪv"),
    ("intro", "^", "(?=d)", "ɪntrə"),
    ("obvi", "^", None, "ɑbvi"),
    ("coffee", None, None, "kɑfi"),
    ("era", "^", "s?$", "ɪrə"),
    ("exit", "^", None, "ɛgzət"),
    ("sugge", None, None, "səgʤɛ"),
    ("news", None, None, "nuz"),
    ("ssia", None, None, "ʃə"),
    ("sian", None, "s?$", "ʒən"),
    ("ptian", None, "s?$", "ʃən"),
    ("stian", None, "s?$", "sʧən"),
    ("nese", None, "s?$", "niz"),
    ("nielle", None, None, "njɛl"),
    ("niel", None, None, "njəl"),
    ("christin", None, None, "krɪstin"),
    ("eith", "[kl]", None, "iθ"),
    ("tthew", None, None, "θju"),
    ("ogo", None, None, "oʊgoʊ"),
    ("joe", None, None, "ʤoʊ"),
    ("ington", None, None, "ɪŋtən"),
    ("ngk", None, None, "ŋk"),
    ("uropean", None, None, "ʊrəpiən"),
    ("urope", None, None, "ʊrəp"),
    # round-17 batch (10.29→10.02 %): soft ge after n/r, -ile → əl,
    # ex+vowel voicing, presence/preserve, -ographer/-igraphy stress,
    # open-syllable a before ci/con/gran, and ~25 irregulars
    ("nge", None, "(?=[sdr]?$)", "nʤ"),
    ("ge", "[rn]", "(?=[sdr]?$)", "ʤ"),
    ("ile", "(?:rt|ag|ut|ss|b)", "s?$", "əl"),
    ("ex", "^", "(?=a|ist|ot|em)", "ɪgz"),
    ("presen", "^", None, "prɛzən"),
    ("preserv", "^", None, "prəzərv"),
    ("rescue", None, None, "rɛskju"),
    ("poe", "^", None, "poʊə"),
    ("schol", None, None, "skɑl"),
    ("eize", None, None, "iz"),
    ("onto", "^", "$", "ɑntu"),
    ("route", "^", None, "rut"),
    ("enator", None, None, "ɛnətər"),
    ("ttle", None, "(?=ment)", "təl"),
    ("ographer", None, None, "ɑgrəfər"),
    ("photog", None, None, "fətɑg"),
    ("igraphy", None, None, "ɪgrəfi"),
    ("ssenger", None, None, "sənʤər"),
    ("sonnel", None, None, "sənɛl"),
    ("aci", None, "(?=al|ous)", "eɪʃ"),
    ("asty", "h", None, "eɪsti"),
    ("aving", "[^h]", None, "eɪvɪŋ"),
    ("acon", None, None, "eɪkən"),
    ("agran", None, None, "eɪgrən"),
    ("jacent", None, None, "ʤeɪsənt"),
    ("arass", None, None, "əræs"),
    ("ortrait", None, None, "ɔrtrət"),
    ("urchase", None, None, "ərʧəs"),
    ("rivilege", None, None, "rɪvləʤ"),
    ("rincip", None, None, "rɪnsəp"),
    ("ought", "dr", None, "aʊt"),
    ("ythm", None, None, "ɪðəm"),
    ("andicap", None, None, "ændikæp"),
    ("onor", "d", None, "oʊnər"),
    ("mony", "[ie]", "$", "moʊni"),
    ("erritor", None, None, "ɛrɪtɔr"),
    ("exual", None, None, "ɛkʃuəl"),
    ("ultimate", None, None, "əltəmət"),
    ("devast", None, None, "dɛvəst"),
    ("cilit", None, None, "sɪlət"),
    ("ourish", None, None, "ərɪʃ"),
    ("unish", "p", None, "ənɪʃ"),
    # round-16 batch (10.62→10.36 %): a+w/adv reductions, compound
    # stems (key-, -fly, like, website), die/tie vs cookie/movie -ie,
    # -ply verbs, design voicing, -ism, and ~15 irregulars
    ("aw", "^", "(?=[ao])", "əw"),
    ("adv", "^", "(?=an|ic|is)", "ədv"),
    ("road", "b", None, "rɔd"),
    ("reathe", None, None, "rið"),
    ("fly", "(?:er|on)", "$", "flaɪ"),
    ("website", None, None, "wɛbsaɪt"),
    ("database", None, None, "deɪtəbeɪs"),
    ("key", "^", None, "ki"),
    ("like", None, None, "laɪk"),
    ("useful", None, None, "jusfəl"),
    ("nusual", None, None, "njuʒuəl"),
    ("soften", None, None, "sɔfən"),
    ("ie", "^" + C + "{1,2}", "s?$", "aɪ"),
    ("ie", V + "[a-z]*" + C, "s?$", "i"),
    ("ply", "(?:p|re|^im|om|ulti)", "$", "plaɪ"),
    ("recent", "^", None, "risənt"),
    ("design", "^", None, "dɪzaɪn"),  # the de- prefix rule consumes d-e first
    ("esign", None, None, "ɪzaɪn"),
    ("apable", None, None, "eɪpəbəl"),
    ("amber", "ch", None, "eɪmbər"),
    ("atalog", None, None, "ætəlɔg"),
    ("atom", "^", "(?=s?$)", "ætəm"),
    ("orps", None, "$", "ɔr"),
    ("arrier", None, None, "æriər"),
    ("icycle", None, None, "aɪsɪkəl"),
    ("anana", None, None, "ənænə"),
    ("attorn", None, None, "ətərn"),
    ("agnos", None, None, "əgnoʊs"),
    ("ssure", None, None, "ʃʊr"),
    ("ediate", "mm", None, "idiət"),
    ("reature", None, None, "riʧər"),
    ("coll", "^", "(?=ect|aps|ide|ab)", "kəl"),
    ("audien", None, None, "ɑdiən"),
    ("ism", None, "s?$", "ɪzəm"),
    # round-15 batch, function-word sweep (10.97→10.64 %): voiced th
    # whole-words (the/this/they/that…), should/would/could, love/above,
    # to/do/who/you, monosyllabic -ied/-ies → aɪd/aɪz, buy/guy
    ("the", "^", "$", "ðə"),
    ("this", "^", "$", "ðɪs"),
    ("these", "^", "$", "ðiz"),
    ("those", "^", "$", "ðoʊz"),
    ("they", "^", "$", "ðeɪ"),
    ("them", "^", "$", "ðɛm"),
    ("then", "^", "$", "ðɛn"),
    ("than", "^", "$", "ðæn"),
    ("that", "^", "$", "ðæt"),
    ("there", "^", "$", "ðɛr"),
    ("their", "^", "$", "ðɛr"),
    ("theirs", "^", "$", "ðɛrz"),
    ("thus", "^", "$", "ðəs"),
    ("though", "^", "$", "ðoʊ"),
    ("thou", "^", "$", "ðaʊ"),
    ("thee", "^", "$", "ði"),
    ("themselves", "^", "$", "ðɛmsɛlvz"),
    ("therefore", "^", "$", "ðɛrfɔr"),
    ("thereby", "^", "$", "ðɛrbaɪ"),
    ("lthough", None, None, "lðoʊ"),
    ("ould", "(?:sh|w|c)", None, "ʊd"),
    ("ove", "(?:^l|^ab|gl|^d|^sh|sc)", "(?:[sd]|rs?|ry|ly)?$", "əv"),
    ("ave", "^h", "$", "æv"),
    ("of", "^", "$", "əv"),
    ("once", "^", "$", "wəns"),
    ("some", "^", "(?=$|thing|one|times|how|where|body|what)", "səm"),
    ("does", "^", "$", "dəz"),
    ("gone", "^", "$", "gɔn"),
    ("to", "^", "$", "tu"),
    ("into", "^", "$", "ɪntu"),
    ("do", "^", "$", "du"),
    ("who", "^", "(?=$|m$|ever)", "hu"),
    ("you", "^", "$", "ju"),
    ("your", "^", None, "jʊr"),
    ("i", "^", "$", "aɪ"),
    ("both", "^", None, "boʊθ"),
    ("only", "^", None, "oʊnli"),
    ("upon", "^", None, "əpɑn"),
    ("toward", "^", "$", "tɔrd"),
    ("almost", "^", None, "ɔlmoʊst"),
    ("going", None, None, "goʊɪŋ"),
    ("any", "(?:^|^m)", None, "ɛni"),
    ("ied", "^" + C + "{1,3}", "$", "aɪd"),
    ("ies", "^" + C + "{1,3}", "$", "aɪz"),
    ("uy", None, None, "aɪ"),
    ("crea", "^", "(?=t)", "krieɪ"),
    ("gain", "^a", None, "gɛn"),
    ("evening", "^", None, "ivnɪŋ"),
    ("presid", "^", "(?=en)", "prɛzəd"),
    ("forg", "^", "(?=[oe])", "fərg"),
    # round-14 batch, fifth 2-edit sweep (11.40→10.98 %): stressed-
    # initial i hiatus → aɪ (via, trial, bias, violent), trans- → trænz
    # before vowel/l/m, more narrow long-o, where/ware/through
    # compounds, and ~30 irregulars
    ("i", "^" + C + "{1,2}", "(?=[aou])", "aɪ"),
    ("irus", None, None, "aɪrəs"),
    ("itamin", None, None, "aɪtəmən"),
    ("cisive", None, None, "saɪsɪv"),
    ("sylum", None, None, "saɪləm"),
    ("ide", None, "(?=ly|ness|st$)", "aɪd"),
    ("unit", "^", "(?=e)", "junaɪt"),
    ("trans", "^", "(?=[ilmau])", "trænz"),
    ("error", None, None, "ɛrər"),
    ("arri", "c", "(?=age|er)", "æri"),
    ("riage", None, None, "rɪʤ"),
    ("ofa", None, None, "oʊfə"),
    ("odium", None, None, "oʊdiəm"),
    ("oter", "v", None, "oʊtər"),
    ("roker", None, None, "roʊkər"),
    ("toe", "^", None, "toʊ"),
    ("oconut", None, None, "oʊkənət"),
    ("ohort", None, None, "oʊhɔrt"),
    ("dona", "^", "(?=t)", "doʊneɪ"),
    ("osal", None, None, "oʊzəl"),
    ("roma", "a", "(?=s?$)", "roʊmə"),
    ("oin", "c", "(?=cid)", "oʊɪn"),
    ("where", "^", None, "wɛr"),
    ("ware", "^", None, "wɛr"),
    ("whoever", None, None, "huɛvər"),
    ("through", None, None, "θru"),
    ("unkn", "^", None, "ənn"),
    ("tour", "^", None, "tʊr"),
    ("anchor", None, None, "æŋkər"),
    ("vey", None, "s?$", "veɪ"),
    ("usage", None, None, "jusəʤ"),
    ("ushion", None, None, "ʊʃən"),
    ("ourtesy", None, None, "ərtəsi"),
    ("ertain", "(?:^c|nc)", None, "ərtən"),
    ("ecies", None, None, "iʃiz"),
    ("aesth", None, None, "ɛsθ"),
    ("orrespond", None, None, "ɔrəspɑnd"),
    ("ratus", None, None, "rætəs"),
    ("gratul", None, None, "græʧə"),
    ("entiate", None, None, "ɛnʃieɪt"),
    ("ciency", None, None, "ʃənsi"),
    ("octrine", None, None, "ɑktrən"),
    ("umentary", None, None, "əmɛntəri"),
    ("vaca", "^", None, "veɪkeɪ"),
    ("therap", None, None, "θɛrəp"),
    ("obacco", None, None, "əbækoʊ"),
    ("anal", "^c", None, "ənæl"),
    ("athedral", None, None, "əθidrəl"),
    ("rena", "a", None, "rinə"),
    ("adol", "^", None, "ædəl"),
    ("ssassin", None, None, "sæsən"),
    ("surance", None, None, "ʃʊrəns"),
    ("aspir", "^", "(?=e)", "əspaɪr"),
    # round-13 batch, fourth 2-edit sweep (11.88→11.40 %): -ssion/-sion
    # after consonant, gu+vowel families (guard, guide, distinguish),
    # narrow long-o words, -come/-journ, label/fatal/native eɪ, -icle/
    # -acle syllabics, and ~20 more irregulars
    ("ssion", None, "s?$", "ʃən"),
    ("sion", C, "s?$", "ʃən"),
    ("uide", None, None, "aɪd"),
    # round-21 batch: long-i families the magic-e rules can't see (the
    # vowel's cue lives 2+ letters downstream) — guidance, isolation,
    # license, migration — plus the stressed/Greek -ol endings
    ("guida", None, None, "gaɪdə"),   # guidance, guidable
    ("guideline", None, None, "gaɪdlaɪn"),
    ("isol", "^", None, "aɪsəl"),     # isolate, isolation
    ("icense", None, None, "aɪsəns"),  # license(d/s)
    ("migr", "^", "a", "maɪgr"),      # migrate, migration, migrant
    ("trol", "[^e]", "s?$", "troʊl"),  # control, patrol (petrol stays əl)
    # -iet(y) is two syllables (quiet, diet, society, variety); juliet/
    # soviet keep iɛt via the lc guard
    ("iety", None, "s?$", "aɪəti"),
    ("iet", "[^lv]", "s?$", "aɪət"),
    ("anxie", "^", None, "æŋzaɪə"),   # anxiety (anxious keeps ŋkʃ)
    # yod-coalescence: word-medial tu before a vowel is ʧu (actual,
    # situation, virtue, mutual — CMUdict CH); word-initial tu (tuesday)
    # and tu+i (intuition) keep t
    ("tu", ".", "(?=[aeo])", "ʧu"),
    ("ohol", None, "s?$", "əhɔl"),    # alcohol
    ("ocol", None, "s?$", "əkɔl"),    # protocol
    ("guar", None, "(?=d)", "gɑr"),
    ("guar", None, "(?=an)", "gɛr"),
    ("guish", None, None, "gwɪʃ"),
    ("oly", "h", None, "oʊli"),
    ("ocer", None, None, "oʊsər"),
    ("ross", "g", None, "roʊs"),
    ("oble", None, "(?!m)", "oʊbəl"),
    ("otable", None, None, "oʊtəbəl"),
    ("locat", "(?:^|[^l])", None, "loʊkeɪt"),
    ("otiv", None, None, "oʊtɪv"),
    ("goti", None, None, "goʊʃi"),
    ("come", None, "s?$", "kəm"),
    ("journ", None, None, "ʤərn"),
    ("onkey", None, None, "əŋki"),
    ("theless", None, None, "ðəlɛs"),
    ("ab", None, "(?=els?$|ors?$)", "eɪb"),
    ("atal", "^" + C + "{1,2}", None, "eɪtəl"),
    ("ative", "^" + C + "{1,2}", "s?$", "eɪtɪv"),
    ("uel", "f", None, "juəl"),
    ("nual", None, None, "njuəl"),
    ("enu", None, "s?$", "ɛnju"),
    ("ile", "(?:ss|ct)", "s?$", "əl"),
    ("icle", None, "s?$", "əkəl"),
    ("acle", None, "s?$", "əkəl"),
    ("iple", "t", None, "əpəl"),
    ("iant", None, "s?$", "aɪənt"),
    ("iamond", None, None, "aɪmənd"),
    ("every", "^", None, "ɛvri"),
    ("ortgage", None, None, "ɔrgəʤ"),
    ("gage", None, None, "geɪʤ"),
    ("courage", None, None, "kərəʤ"),
    ("ortun", "f", None, "ɔrʧən"),
    ("obs", "^", "(?=erv[ei])", "əbz"),
    ("offen", "^", None, "əfɛn"),
    ("orange", None, None, "ɔrənʤ"),
    ("alace", None, None, "æləs"),
    ("hy", "^", "(?=[bdgpt])", "haɪ"),
    ("quir", None, "(?!r)", "kwaɪr"),
    ("orecast", None, None, "ɔrkæst"),
    ("forev", "^", None, "fərɛv"),
    ("phas", "m", None, "fəs"),
    ("evil", "d", None, "ɛvəl"),
    ("evil", "^", None, "ivəl"),
    ("essert", None, None, "ɪzərt"),
    ("educ", "^", None, "ɛʤək"),
    ("uip", None, None, "wɪp"),
    ("dg", None, None, "ʤ"),
    # round-12 batch, third 2-edit sweep (12.25→11.88 %): -ough/-augh
    # families, vocalized l (palm, folk), French -age/-chute/-igue,
    # -stion/-cient/-cian/-asion suffixes, and silent-letter irregulars
    # (sword, indict, whose, receipt-family cei → si)
    ("ough", "(?:^t|^r|sl|en)", "$", "əf"),
    ("ough", "(?:^c|tr)", "$", "ɔf"),
    ("augh", "(?:^l|dr)", None, "æf"),
    ("alm", None, None, "ɑm"),
    ("olk", None, None, "oʊk"),
    ("sword", "^", None, "sɔrd"),
    ("age", "(?:ir|ot)", "s?$", "ɑʒ"),
    ("chute", None, None, "ʃut"),
    ("gauge", None, None, "geɪʤ"),
    ("suite", None, "(?=s?$)", "swit"),
    ("atigue", None, None, "ətig"),
    ("igue", None, "$", "ig"),
    ("stion", None, "s?$", "sʧən"),
    ("ggest", None, None, "gʤɛst"),
    ("cient", None, None, "ʃənt"),
    ("cian", None, "s?$", "ʃən"),
    ("eation", None, None, "ieɪʃən"),
    ("asion", None, None, "eɪʒən"),
    ("osion", None, None, "oʊʒən"),
    ("cei", None, None, "si"),
    ("one", "(?:^d|^n)", "$", "ən"),
    ("love", "g", None, "ləv"),
    ("hose", "^w", None, "huz"),
    ("hoe", "s", None, "u"),
    ("our", "^p", "s?$", "ɔr"),
    ("steak", None, None, "steɪk"),
    ("sew", "^", "(?!e)", "soʊ"),
    ("eopard", None, None, "ɛpərd"),
    ("enate", None, None, "ɛnət"),
    ("arch", None, "(?=itect|ival|ive)", "ɑrk"),
    ("narch", None, None, "nərk"),
    ("yo", "^", "(?=ga|gurt)", "joʊ"),
    ("acqu", "^", "(?=ir|ain)", "əkw"),
    ("adj", "^", "(?=u|ac|oin)", "əʤ"),
    ("bsor", None, None, "bzɔr"),
    ("indict", None, None, "ɪndaɪt"),
    ("tsu", "^", None, "su"),
    ("appr", "^", "(?=ec|ov|oach|opr)", "əpr"),
    # round-11 batch, second 2-edit sweep (12.47→12.25 %) — listed
    # BEFORE round-10 so breakfast beats the break rule at the same
    # position (list order, not length, breaks ties)
    ("our", None, "(?=[st])", "ɔr"),
    ("oar", None, None, "ɔr"),
    ("ouch", "t", None, "əʧ"),
    ("oupl", None, None, "əpl"),
    ("essure", None, None, "ɛʃər"),
    ("nature", "^", None, "neɪʧər"),
    ("ure", V + "[a-z]*[gl]", "s?$", "jər"),
    ("isl", "^", None, "aɪl"),
    ("overnment", None, None, "əvərmənt"),
    ("azine", None, "s?$", "əzin"),
    ("iew", None, None, "ju"),
    ("olice", None, None, "əlis"),
    ("isease", None, None, "ɪziz"),
    ("lease", "^p", None, "liz"),
    ("tomach", None, None, "təmək"),
    ("edule", None, None, "ɛʤʊl"),
    ("oldier", None, None, "oʊlʤər"),
    ("ofess", None, None, "əfɛs"),
    ("elcome", None, None, "ɛlkəm"),
    ("ompany", None, None, "əmpəni"),
    ("ninet", "^", None, "naɪnt"),
    ("uly", "j", None, "ulaɪ"),
    ("allow", "^", None, "əlaʊ"),
    ("oh", "^", "$", "oʊ"),
    ("one", "^", "s?$", "wən"),
    ("reakfast", None, None, "rɛkfəst"),
    ("lenge", None, None, "lənʤ"),
    ("anim", "^", "(?=al)", "ænəm"),
    ("erience", None, None, "ɪriəns"),
    ("egion", None, None, "iʤən"),
    ("pinion", None, None, "pɪnjən"),
    # round-10 batch, mined from the 2-edit tail (12.90→12.47 %):
    # monosyllabic Cy → aɪ (fly, cry, try, why), -ire → aɪər (fire,
    # require, desire), group/young/country ou, open-syllable aCer → eɪ
    # (paper, later, baker), prove/move/receive, and common irregulars
    ("y", "^" + C + "{1,3}", "$", "aɪ"),
    ("ire", None, "s?$", "aɪər"),
    ("ired", None, "$", "aɪərd"),
    ("oup", None, "(?![aeioul])", "up"),
    ("oung", None, "(?!e)", "əŋ"),
    ("ountry", None, None, "əntri"),
    ("four", None, None, "fɔr"),
    ("our", "(?:^y|t)", "s?$", "ʊr"),
    ("said", "^", None, "sɛd"),
    ("says", "^", None, "sɛz"),
    ("eople", None, None, "ipəl"),
    ("reak", "(?:^b|^g)", None, "reɪk"),
    ("reat", "^g", None, "reɪt"),
    ("foreign", None, None, "fɔrən"),
    ("sovereign", None, None, "sɑvrən"),
    ("argue", None, None, "ɑrgju"),
    ("idea", "^", None, "aɪdiə"),
    ("often", "^", None, "ɔfən"),
    ("uesday", None, None, "uzdeɪ"),
    ("ednesday", None, None, "ɛnzdeɪ"),
    ("anguage", None, None, "æŋgwəʤ"),
    ("ontrol", None, None, "əntroʊl"),
    ("rove", "(?:^p|mp|pp)", None, "ruv"),
    ("move", None, None, "muv"),
    ("eive", None, None, "iv"),
    ("a", None, "(?=[bcdgkmptvz]ers?$)", "eɪ"),
    ("ajor", None, None, "eɪʤər"),
    ("ober", None, "$", "oʊbər"),
    ("mong", "a", None, "mʌŋ"),
    ("mon", "^", "(?=ey|th|k)", "mʌn"),
    ("eau", "b", None, "ju"),
    ("gether", None, None, "gɛðər"),
    ("sual", None, None, "ʒuəl"),
    # reducible prefixes (unstressed in most derived words: behave, depict,
    # resign, exclude, confirm — CMUdict reduces these to ɪ/ə). The
    # doubled-letter lookahead keeps them off closed first syllables
    # (better, pretty, commons — a doubled consonant closes the syllable,
    # so the vowel is stressed-short, not a reduced prefix)
    ("be",  "^", r"(?!(.)\1)" + C + "[a-z]*" + V, "bɪ"),
    ("de",  "^", r"(?!(.)\1)" + C + "[a-z]*" + V, "dɪ"),
    ("re",  "^", "(?=f[eilu])", "rə"),  # refer, reflect, refuse
    ("re",  "^", r"(?!(.)\1)" + C + "[a-z]*" + V, "rɪ"),
    ("pre", "^", "(?=f)", "prə"),   # prefer (CMU AH0)
    ("pre", "^", r"(?!(.)\1)" + C + "[a-z]*" + V, "prɪ"),
    ("ex",  "^", C, "ɪks"),
    ("comm", "^", "[aeiouy]", "kəm"),  # commit, command, communicate
    ("conn", "^", "[aeiouy]", "kən"),  # connect, connection
    ("con", "^", r"(?!(.)\1)" + C + "[a-z]*" + V, "kən"),
    ("com", "^", r"(?!(.)\1)" + C + "[a-z]*" + V, "kəm"),
    # unstressed suffixes (vowel required earlier in the word so short
    # monosyllables — went, ant, pal, age — keep their full vowel).
    # Inflected variants (-tions, -ments, -ors, …) come FIRST: rule
    # matching is first-match, and the bare "$"-anchored forms cannot
    # fire with a trailing s — without these, every plural of a suffixed
    # word fell through to letter-by-letter ɛs/ɔrs endings (the largest
    # single error class in the round-3 PER analysis)
    ("ations", None, "$", "eɪʃənz"),
    ("tions",  None, "$", "ʃənz"),
    ("sions",  V + "$", "$", "ʒənz"),
    ("sions",  None, "$", "ʃənz"),
    ("ments",  V + "[a-z]*", "$", "mənts"),
    ("ances",  V + "[a-z]*", "$", "ənsəz"),
    ("ences",  V + "[a-z]*", "$", "ənsəz"),
    ("ians",   None, "$", "iənz"),
    ("ors",    V + "[a-z]*", "$", "ərz"),
    ("ers",    V + "[a-z]*", "$", "ərz"),
    ("als",    V + "[a-z]*", "$", "əlz"),
    ("ives",   V + "[a-z]*", "$", "ɪvz"),
    ("ies",    C + "$", "$", "iz"),
    ("ied",    C + "$", "$", "id"),
    ("ology",   None, "$", "ɑləʤi"),
    ("ography", None, "$", "ɑgrəfi"),
    ("ously",   V + "[a-z]*", "$", "əsli"),
    ("ages",    V + "[a-z]*", "$", "ɪʤəz"),
    ("able",    V + "[a-z]*", "$", "əbəl"),
    ("ible",    V + "[a-z]*", "$", "əbəl"),
    ("ibrar",   None, None, "aɪbrɛr"),  # library, libraries
    # place/person-name codas (washington, johnson, oxford, poland)
    ("ton",     V + "[a-z]*", "$", "tən"),
    ("son",     V + "[a-z]*" + C, "$", "sən"),  # johnson — not reason
    ("ford",    V + "[a-z]*", "$", "fərd"),
    ("land",    V + "[a-z]*", "$", "lənd"),
    ("el",      V + "[a-z]*", "$", "əl"),
    ("ators", None, "$", "eɪtərz"),
    ("ator",  None, "$", "eɪtər"),
    ("ation", None, None, "eɪʃən"),
    ("tion",  None, None, "ʃən"),
    ("sion",  V + "$", None, "ʒən"),
    ("sion",  None, None, "ʃən"),
    ("cious", None, None, "ʃəs"),
    ("tious", None, None, "ʃəs"),
    ("cial",  None, None, "ʃəl"),
    ("tial",  None, None, "ʃəl"),
    ("ment",  V + "[a-z]*", "$", "mənt"),
    ("ness",  None, "$", "nəs"),
    ("ous",   V + "[a-z]*", "$", "əs"),
    ("ance",  V + "[a-z]*", "$", "əns"),
    ("ence",  V + "[a-z]*", "$", "əns"),
    ("ant",   V + "[a-z]*", "$", "ənt"),
    ("ent",   V + "[a-z]*", "$", "ənt"),
    ("age",   V + "[a-z]*", "$", "əʤ"),  # manage, message (CMU AH0)
    ("ful",   V + "[a-z]*", "$", "fəl"),
    ("ism",   V + "[a-z]*", "$", "ɪzəm"),
    ("ity",   V + "[a-z]*", "$", "əti"),
    ("acy",   None, "$", "əsi"),
    ("ive",   "(?:surv|arr|al|rev|der|str|conn)", "s?$", "aɪv"),
    #   stress-final -ive verbs (survive, arrive, alive, derive)
    ("ive",   V + "[a-z]*", "$", "ɪv"),
    ("ian",   None, "$", "iən"),
    ("al",    V + "[a-z]*", "$", "əl"),
    ("or",    V + "[a-z]*", "$", "ər"),
    ("le",    "[bcdfgkpstvz]", "$", "əl"),
    # multi-letter graphemes
    ("ture",  None, "$", "ʧər"),
    ("tures", None, "$", "ʧərz"),
    ("tur",   None, V, "ʧər"),
    # plural / 3sg endings: voiced after vowels and voiced consonants,
    # syllabic after sibilants (machines → -nz, uses → -zəz, boxes — the
    # raw-rule endings previously spelled the 'e' as ɛ and the s as /s/)
    ("less",  V + "[a-z]*", "$", "ləs"),
    ("oes",   None, "$", "oʊz"),
    ("ise",   "(?:prom|prem)", "s?$", "əs"),  # promise, premise
    ("ise",   V + "[a-z]*", "$", "aɪz"),   # advertise, otherwise, sunrise
    ("ise",   "[rw]", "s?$", "aɪz"),       # rise, wise
    ("isen",  None, "$", "ɪzən"),          # risen, arisen
    ("oise",  "[^t]", "$", "ɔɪz"),         # noise — not tortoise
    ("lease", "p", "s?$", "liz"),          # please
    ("oose",  "ch", "s?$", "uz"),          # choose
    #   (verb-forming -ise voices; promise/premise are lexicon entries)
    ("sis",   None, "$", "səs"),           # analysis, basis, diagnosis
    ("is",    V + "[a-z]*" + C, "$", "əs"),
    ("us",    None, "$", "əs"),            # campus, virus — never voiced
    ("as",    V + "[a-z]*", "$", "əs"),    # christmas, atlas, canvas
    ("ss",    None, "$", "s"),
    ("ated",  V + "[a-z]*", "$", "eɪtəd"),
    ("ates",  V + "[a-z]*", "$", "eɪts"),
    ("es",    "(s|x|z|ch|sh|c|g)", "$", "əz"),
    ("es",    "[kpft]", "$", "s"),   # makes, tapes: voiceless coda
    ("es",    V + "[a-z]+", "$", "z"),
    ("s",     "[aeiouy][a-z]*[bdglmnrvw]", "$", "z"),
    ("s",     V, "$", "z"),
    # latinate/greek & loanword onsets and codas
    ("ex",    "^$", "[ai]", "ɪgz"),
    ("pn",    "^$", None, "n"),
    ("que",   None, "$", "k"),
    ("eau",   None, None, "oʊ"),
    ("u",     "^$", "(n[iey]|s[aeiouy]|t[aeiouy])", "ju"),
    ("e",     None, "(?=dia|gal|male|qual)", "i"),  # media, legal,
    #   female, equal
    ("e",     "^$", "r[aeiou]", "ɪ"),  # erase, erosion, erupt — not
    #   error/errand (the doubled r blocks the context)
    # closed-compound function words (someone, everywhere, sometimes)
    ("some",  "^$", "[a-z]", "səm"),
    ("ident", "^$", None, "aɪdɛnt"),  # identify, identity, identical
    ("y",     "^m", "self", "aɪ"),    # myself
    ("inth",  None, "$", "aɪnθ"),     # ninth
    ("inus",  None, "$", "aɪnəs"),    # minus, sinus
    ("isis",  None, "$", "aɪsəs"),    # crisis
    ("item",  "^$", None, "aɪtəm"),   # item, items
    ("iday",  "r", "$", "aɪdeɪ"),     # friday (not holiday)
    ("one",   "(some|any|every)", "$", "wən"),
    ("where", "(some|any|every|no)", "$", "wɛr"),
    ("times", V + "[a-z]*", "$", "taɪmz"),
    # palatalization before a (associate, negotiate, sociable — NOT
    # society/science, where i is a full nucleus)
    ("ci",    "[aeiou]", "a", "ʃi"),
    ("ti",    "[aeiou]", "a", "ʃi"),
    ("ia",    None, "$", "iə"),
    ("sm",    V, "$", "zəm"),
    ("ought", None, None, "ɔt"),
    ("aught", None, None, "ɔt"),
    ("augh",  None, None, "æf"),
    ("ough",  None, "$", "oʊ"),
    ("igh",   None, None, "aɪ"),
    ("eigh",  None, None, "eɪ"),
    ("tch",   None, None, "ʧ"),
    ("dge",   None, None, "ʤ"),
    ("sch",   None, None, "sk"),
    ("other", "(?:^|[mn]|br|an)$", "s?$", "əðər"),  # mother, other
    ("eather", None, "s?$", "ɛðər"),   # weather, leather, feather
    ("ather", "f", "s?$", "ɑðər"),     # father
    ("ther",  V + "[a-z]*", "s?$", "ðər"),  # mother, weather, either
    ("ch",    "^$", "(?=emi|oru|aos|asm|ole|rys)", "k"),  # Greek onsets
    ("ch",    None, C, "k"),     # greek/loan clusters: technical, chrome
    ("ch",    None, None, "ʧ"),
    ("ck",    None, None, "k"),
    ("sh",    None, None, "ʃ"),
    ("th",    None, None, "θ"),
    ("ph",    None, None, "f"),
    ("gh",    "^$", None, "g"),      # word-initial gh
    ("gh",    None, None, ""),        # silent otherwise
    ("wh",    None, "o", "h"),        # who, whole
    ("wh",    None, None, "w"),
    ("wr",    "^$", None, "r"),
    ("kn",    "^$", None, "n"),
    ("gn",    "^$", None, "n"),
    ("ps",    "^$", None, "s"),
    ("qu",    None, None, "kw"),
    ("y",     C + "$", "(?=ing$)", "aɪ"),  # trying, flying, drying
    ("ngine", None, "$", "nʤən"),  # engine: soft g, before ng binds
    ("ng",    None, "$", "ŋ"),
    ("ng",    None, None, "ŋg"),
    ("nk",    None, None, "ŋk"),
    ("alk",   None, None, "ɔk"),
    ("all",   None, "(e[dn]|ing|s)?$", "ɔl"),  # call, called, falling
    ("alt",   None, None, "ɔlt"),              # salt, halt, asphalt
    # long-i codas: find/kind/mind, child/wild (not build), sign/design
    ("ind",   None, "(?:ings?|s)?$", "aɪnd"),  # find, finding; hinder/window unaffected
    ("ild",   "[^u]", "s?$", "aɪld"),
    ("ign",   "[^e]", "s?$", "aɪn"),
    # open-o before voiced/fortis codas (CMU ɔ): long, across, dog, lost
    ("ong",   "[^m]", "(?!e)", "ɔŋ"),  # long, strong — not among/month
    ("oss",   None, "$", "ɔs"),
    ("ost",   "[lfr]", "$", "ɔst"),
    ("og",    "[dlh]", "s?$", "ɔg"),
    ("ory",   V + "[a-z]*", "$", "əri"),   # history, memory, factory
    ("ause",  None, None, "ɔz"),            # because, cause, pause
    ("ose",   "purp", "s?$", "əs"),         # purpose
    ("ose",   "[hrpn]", "s?$", "oʊz"),      # those, rose, suppose, nose
    ("s",     "^u", "[ei]", "z"),           # use(d/r), using — verb voicing
    ("s",     "^d?i", "[aeiou]", "s"),      # dis-/iso- prefixes stay s
    ("s",     V + "$", "[aiouy]", "z"),     # intervocalic voicing: music,
    #   easy, reason, result — NOT before silent e (house, promise stay s)
    ("s",     V + "$", "[bdgmn]", "z"),     # husband, wisdom: voiced cluster
    ("u",     "[pf]", "(ll?|sh|t)s?$", "ʊ"),  # put, pull, full, push
    ("uth",   None, "$", "uθ"),             # truth, ruth
    ("ion",   "[ln]", "s?$", "jən"),        # million, union, opinion
    # u before r+vowel is lax (during, jury; kj after k/p — curious)
    ("u",     "[ckp]", "r[aeiouy]", "jʊ"),
    ("u",     None, "r[aeiouy]", "ʊ"),
    # open-syllable u: long (student, duty; ju after labials/velars —
    # music, future). 'stud' is the systematic exception (study, studies)
    ("u",     "st", "d(y|ies|ied)$", "ə"),  # study — not student/studio
    ("u",     "[mfpbvkh]", C + "[aeiouy]", "ju"),
    ("u",     None, C + "[aeiouy]", "u"),
    ("off",   "^$", "(?:ice|er|$)", "ɔf"),  # office, offer, off
    #   (official/offensive keep the reducible o)
    ("gine",  V + "[a-z]*", "$", "ʤən"),  # imagine
    # 'o' before ld/st codas is long (told, golden, most, host — the
    # letter-default ɑ was the largest ɑ→oʊ error class)
    ("old",   None, None, "oʊld"),
    ("olt",   None, None, "oʊlt"),
    ("ost",   "[mhpg]", "$", "oʊst"),
    ("ange",  None, "$", "eɪnʤ"),
    ("ange",  "[a-z]", "[rds]", "eɪnʤ"),  # danger, stranger, changed
    ("aken",  None, None, "eɪkən"),       # taken, shaken, mistaken
    ("an",    None, "(?=cien|gel)", "eɪn"),  # ancient, angel
    ("ata",   "[^n]", "$", "eɪtə"),       # data, strata — not sonata
    ("asis",  None, "$", "eɪsəs"),        # basis, oasis
    ("asi",   None, "[sc]", "eɪs"),       # basic, occasional
    ("yst",   V + "[a-z]*", "s?$", "əst"),  # analyst, catalyst
    ("it",    V + "[a-z]*[^aeiouym]", "$", "ət"),  # habit, orbit, profit
    #   (-mit verbs stress the final syllable: admit, permit)
    ("a",     None, "[bcdfgklmnprst]ing$", "eɪ"),  # making, amazing
    ("i",     None, "[bcdfgklmnprst]ing$", "aɪ"),  # riding, timing
    ("nge",   None, "$", "nʤ"),
    # long-o morphological families (tokens, unspoken, motorist, oceans,
    # locally, totally, bonuses, polarized, domains)
    ("oken",  None, None, "oʊkən"),
    ("onent", None, None, "oʊnənt"),  # component, opponent, exponent
    ("onial", None, None, "oʊniəl"),  # colonial, ceremonial
    ("onia",  None, None, "oʊniə"),   # pneumonia, patagonia
    ("oment", None, None, "oʊmənt"),
    ("otor",  None, None, "oʊtər"),
    ("ocean", None, None, "oʊʃən"),
    ("otion", None, None, "oʊʃən"),  # motion, emotion, promotion
    ("ania",  None, "$", "eɪniə"),   # albania, romania
    ("eria",  None, "$", "ɪriə"),    # bacteria, criteria, cafeteria
    ("ere",   "w", "$", "ər"),       # were
    ("ere",   "wh", "$", "ɛr"),      # where (wh→w consumed the h)
    ("here",  "^$", "$", "hir"),     # here (CMU IY)
    ("ere",   None, "s?$", "ɪr"),    # sphere, severe, atmosphere
    ("ero",   "z", "s?$", "ɪroʊ"),   # zero(s)
    ("cent",  "per", "s?$", "sɛnt"),  # percent
    ("sday",  None, "s?$", "zdeɪ"),   # thursday, tuesday, wednesday
    # reduced-o families (CMU AH0/AH1: from/among-class 'o' before
    # nasals in closed syllables)
    ("oming", None, "$", "əmɪŋ"),   # coming, becoming
    ("othing", None, "$", "əθɪŋ"),  # nothing
    ("oney",  None, "s?$", "əni"),  # money, honey
    ("onday", None, "s?$", "əndeɪ"),
    ("onth",  None, None, "ənθ"),   # month(s), monthly
    ("ront",  None, None, "rənt"),  # front, confront
    ("o",     "^pr", "(?=vi|te[ck]|du|po)", "ə"),  # provide, protect,
    #   produce, propose — not program/process
    ("otal",  None, None, "oʊtəl"),
    ("oto",   None, "$", "oʊtoʊ"),    # photo
    ("otive", None, "s?$", "oʊtɪv"),  # motive, emotive
    ("otel",  None, "s?$", "oʊtɛl"),  # hotel, motel
    ("ome",   None, "(?=work|town|made|sick|page|land)", "oʊm"),  # home-
    ("omb",   "c", "s?$", "oʊm"),     # comb — not bomb/tomb
    ("open",  "(?:^|re)$", None, "oʊpən"),  # open(ing), reopen
    ("ocus",  None, None, "oʊkəs"),
    ("ocal",  None, None, "oʊkəl"),
    ("otice", None, None, "oʊtəs"),
    ("onus",  None, None, "oʊnəs"),
    ("olar",  None, None, "oʊlər"),
    ("omain", None, None, "oʊmeɪn"),
    ("over",  "^", None, "oʊvər"),
    ("aste",  None, None, "eɪst"),   # waste, taste, paste (two-consonant
    #                                  coda blocks magic-e)
    ("avor",  None, None, "eɪvər"),  # favor, flavor, behavior
    ("a",     None, "d[iy]", "eɪ"),  # lady, radio, stadium
    ("ood",   "(?:st|[wgh])", "$", "ʊd"),  # good, wood, stood — not food
    ("oot",   "f", None, "ʊt"),            # foot — not root/boot
    ("oo",    None, "k", "ʊ"),
    ("oo",    None, None, "u"),
    ("ee",    None, None, "i"),
    ("ear",   "h", "s?$", "ir"),      # hear (CMU IY) — not heart
    ("ear",   "[^bw]", "s?$", "ɪr"),  # year, fear, appear — not bear
    ("ear",   None, "[cdfghklmnp]", "ər"),  # heard, learn, early, search
    ("ead",   None, "$", "ɛd"),
    # short-e 'ea' contexts (meant, health, breakfast, weapon, meadow,
    # pleasant, measure/pleasure-family)
    ("ea",    None, "(?=nt|lth|kf|sur|ven|pon|sant|dow|lous|lth)", "ɛ"),
    ("ea",    None, None, "i"),
    ("eur",   None, None, "jʊr"),
    ("eu",    None, None, "ju"),
    ("ui",    None, None, "u"),
    ("air",   None, None, "ɛr"),   # air, aircraft (before the ai digraph)
    ("eir",   None, "s?$", "ɛr"),  # heir, their
    ("ai",    None, None, "eɪ"),
    ("ay",    None, None, "eɪ"),
    ("ey",    None, "$", "i"),
    ("ei",    None, None, "eɪ"),
    ("au",    None, None, "ɔ"),
    ("aw",    None, None, "ɔ"),
    ("oa",    None, None, "oʊ"),
    ("ow",    None, "$", "oʊ"),
    ("ow",    None, None, "aʊ"),
    ("ou",    None, None, "aʊ"),
    ("oi",    None, None, "ɔɪ"),
    ("oy",    None, None, "ɔɪ"),
    ("ie",    "fr", None, "ɛ"),   # friend, friendly
    ("ea",    "(?:ar|id)", "s?$", "iə"),  # area, idea(s)
    ("our",   "(?:^|h)", "s?$", "aʊər"),  # our, hour(s) — not four
    ("dred",  None, "$", "drəd"),         # hundred, kindred
    ("les",   "[bcdfgkpstvz]", "$", "əlz"),  # examples, tables, candles
    ("ie",    None, "$", "aɪ"),
    ("ie",    None, None, "i"),
    ("ue",    V + "[a-z]*[nl]", "$", "ju"),  # value, continue, venue
    ("ue",    None, "$", "u"),
    ("ew",    "f", None, "ju"),              # few
    ("ew",    None, None, "u"),
    ("cc",    None, "[eiy]", "ks"),
    ("cc",    None, None, "k"),
    ("gue",   None, "$", "g"),
    ("gu",    None, "[ei]", "g"),
    ("mb",    None, "$", "m"),
    ("oup",   None, None, "up"),
    ("air",   None, None, "ɛr"),
    ("ier",   None, C, "ɪr"),
    ("fy",    V + "[a-z]*", "$", "faɪ"),
    ("ply",   V + "[a-z]*", "$", "plaɪ"),
    ("pf",    "^", None, "f"),
    ("ted",   None, "$", "təd"),
    ("ded",   None, "$", "dəd"),
    ("ed",    V + "[a-z]*", "$", "d"),
    ("wor",   "^", C, "wər"),
    ("ar",    "[wu]", None, "ɔr"),  # war, quarter
    # doubled r: the vowel is NOT r-colored (sorry, cherry, mirror,
    # hurry); 'a' before intervocalic r fronts to ɛ (care, parent)
    ("arr",   "^$", "[aeiouy]", "ər"),  # arrive, arrange, arrest
    ("arr",   None, "[aeiouy]", "ɛr"),
    ("err",   None, "[aeiouy]", "ɛr"),
    ("irr",   None, "[aeiouy]", "ɪr"),
    ("orr",   None, "[aeiouy]", "ɑr"),
    ("urr",   None, "[aeiouy]", "ər"),
    ("ar",    "^$", "(?=ou|i[sv]|o[sm])", "ər"),  # around, arise, aroma
    ("ar",    None, "[aeiouy]", "ɛr"),
    ("ar",    None, None, "ɑr"),
    ("er",    None, None, "ər"),
    ("ir",    None, None, "ər"),
    ("ur",    None, None, "ər"),
    ("or",    None, None, "ɔr"),
    # magic-e: vowel + single consonant + e$, also through the -s/-d
    # inflection tails (makes, named, times, notes — the blocked-by-s
    # default 'a' was the largest æ→eɪ error class)
    ("a",     None, C + "e[sd]?$", "eɪ"),
    ("i",     None, C + "e[sd]?$", "aɪ"),
    ("o",     None, C + "e[sd]?$", "oʊ"),
    ("u",     None, C + "e[sd]?$", "ju"),
    ("e",     None, C + "e[sd]?$", "i"),
    ("y",     None, C + "e[sd]?$", "aɪ"),  # style, type, bytes
    # open-syllable long vowels before a SINGLE consonant (doubled
    # consonants now reach the rules intact, so table/apple and
    # baby/happy are distinguishable)
    ("a",     None, C + "le$", "eɪ"),   # table, cable, stable, able
    ("a",     None, C + "y$", "eɪ"),    # baby, navy, lazy, crazy
    ("oll",   None, "$", "oʊl"),        # poll, roll, toll, scroll
    ("i",     "^" + C + "{1,2}$", "nal", "aɪ"),  # final, spinal — not
    #   criminal/original (the i sits deeper in the word)
    ("i",     "^s", "lent", "aɪ"),      # silent
    ("i",     "^pr", "mar", "aɪ"),      # primary
    ("imb",   "cl", None, "aɪm"),       # climb
    ("o",     "^t", "(?=day|morrow|night|gether)", "ə"),  # today, tonight
    ("i",     None, C + "le$", "aɪ"),   # title, bible, rifle (doubled
    #                                     consonants block: little)
    ("i",     None, "[td]ers?$", "aɪ"),  # writer, rider, spider
    # single letters
    ("a",     "[wu]", None, "ɑ"),  # want, watch, wash, quality
    ("a",     "^$", C + "[aeiouy]", "ə"),  # about, again, around (unstressed)
    ("i",     None, "[aeou]", "i"),        # hiatus: period, curious, union
    ("a",     None, None, "æ"),
    ("e",     "^" + C + "+", "$", "i"),  # CV monosyllable: me, he, she
    ("e",     None, "$", ""),         # final silent e
    ("e",     None, None, "ɛ"),
    ("i",     None, "$", "i"),
    ("i",     None, None, "ɪ"),
    ("o",     None, "$", "oʊ"),
    ("o",     None, None, "ɑ"),
    ("u",     None, None, "ə"),
    ("y",     "^$", None, "j"),
    ("y",     None, "$", "i"),
    ("y",     None, None, "ɪ"),
    # doubled consonants spell one sound (pass, hull, apparent); handled
    # IN the cascade rather than by a pre-pass so single-vs-double
    # consonant context stays visible to the open-syllable rules above
    # (table vs apple, baby vs happy)
    ("bb", None, None, "b"), ("dd", None, None, "d"),
    ("ff", None, None, "f"), ("gg", None, None, "g"),
    ("kk", None, None, "k"), ("ll", None, None, "l"),
    ("mm", None, None, "m"), ("nn", None, None, "n"),
    ("pp", None, None, "p"), ("rr", None, None, "r"),
    ("ss", None, None, "s"), ("tt", None, None, "t"),
    ("vv", None, None, "v"), ("zz", None, None, "z"),
    ("xx", None, None, "ks"),
    ("b", None, None, "b"), ("c", None, "[eiy]", "s"),
    ("c", None, None, "k"), ("d", None, None, "d"),
    ("f", None, None, "f"), ("g", None, "[eiy]", "ʤ"),
    ("g", None, None, "g"), ("h", None, None, "h"),
    ("j", None, None, "ʤ"), ("k", None, None, "k"),
    ("l", None, None, "l"), ("m", None, None, "m"),
    ("n", None, None, "n"), ("p", None, None, "p"),
    ("r", None, None, "r"),
    ("s", None, None, "s"), ("t", None, None, "t"),
    ("v", None, None, "v"), ("w", None, None, "w"),
    ("x", None, None, "ks"), ("z", None, None, "z"),
    ("q", None, None, "k"),
    ("'", None, None, ""),
]
# fmt: on

_compiled_rules = [
    (
        g,
        re.compile((lc or "") + "$") if lc else None,
        re.compile("^" + rc) if rc else None,
        out,
    )
    for g, lc, rc, out in _LTS_RULES
]

# ---------------------------------------------------------------------------
# Grapheme-origin detection (VERDICT r4 #3): loanwords keep their source
# language's letter-to-sound conventions, which English rules render
# wrongly (zeitgeist-class). Strong orthographic markers classify a word
# as German- or French-origin; matching words run a small rule OVERLAY
# before the main cascade. Markers are deliberately high-precision
# clusters that native English spelling essentially never produces.
# ---------------------------------------------------------------------------

_GERMAN_RE = re.compile(
    r"zeit|stein|geist|krieg|berg$|burg$|mann$|heim$|bach$|wald$|"
    r"hof$|reich|schaft|sch(?=[lmnrwb])|schu(?=[blmr])|"
    r"(?<=[aeiou])tz$|^(?:ge|vor|über)schich"
)
# the -et$ marker is an explicit stem list: a bare consonant+et$
# lookbehind caught native words (get, set, asset)
_FRENCH_RE = re.compile(
    r"(?<!b)eau|eaux$|oux$|ieux?$|oire?$|euse$|esque$|aise$|"  # beauty/beautiful are bjut-native
    r"(?:ball|buff|bouqu|cabar|chal|crochet|croqu|fill|gourm|parqu|"
    r"piqu|rico?ch|sorb|val|ber)et$|oye|"
    r"croiss|gnon|gnac|aille|ouche$|outte$|chine$|"
    r"^(?:ch(?:amois|ampagne|auffeur|agrin|alet|andelier|artreuse|"
    r"ateau|emise|evron|iffon|anteuse)|rendezv|silhou|bourgeo|"
    r"connoisse|entrepren|camoufl|repertoi|croch)"
)

# overlay rules, same shape as _LTS_RULES, tried BEFORE the main cascade
_GERMAN_RULES = [
    ("sch", None, None, "ʃ"),     # schmidt, schultz (Greek sch→sk stands
    #                               outside German-marked words)
    ("ei",  None, None, "aɪ"),    # zeitgeist, stein, rhein
    ("eu",  None, None, "ɔɪ"),    # freud, deutsche
    ("tz",  None, None, "ts"),    # katz, glitz
    ("dt",  None, "$", "t"),      # schmidt, brandt
    ("th",  None, None, "t"),     # neanderthal, goethe
    ("oe",  None, None, "ɜ"),
    ("u",   None, "l", "ʊ"),      # schultz, schulz
    ("g",   None, "[ei]", "g"),   # geist, krieger: hard g before e/i
]
_FRENCH_RULES = [
    ("eaux", None, "$", "oʊz"),
    ("eau",  None, None, "oʊ"),
    ("aise", None, "$", "eɪz"),
    ("ieux", None, "$", "ju"),
    ("ieu",  None, "$", "ju"),
    ("oire", None, "$", "wɑr"),
    ("oir",  None, "$", "wɑr"),
    ("euse", None, "$", "uz"),    # masseuse, chanteuse
    ("eur",  None, None, "ər"),   # chauffeur, entrepreneur
    ("au",   None, None, "oʊ"),   # chauffeur, gauche
    ("oux",  None, "$", "u"),
    ("oy",   None, V, "waɪ"),     # voyeur, foyer
    ("ch",   None, None, "ʃ"),    # chauffeur, champagne, chamois
    ("ou",   None, None, "u"),    # rouge, routine-class
    ("ine",  None, "s?$", "in"),  # machine, cuisine (not magic-e aɪ)
    ("et",   None, "$", "eɪ"),    # bouquet, ballet, chalet
    ("oi",   None, None, "wɑ"),   # chamois... (s$ silent below)
    ("s",    "oi", "$", ""),      # chamois: silent final s after -oi
    ("que",  None, "$", "k"),
    ("qu",   None, None, "k"),    # bouquet, piquet (no English kw glide)
    ("gn",   V, V, "nj"),         # cognac, mignon
]

_german_rules_c = [
    (g, re.compile((lc or "") + "$") if lc else None,
     re.compile("^" + rc) if rc else None, out)
    for g, lc, rc, out in _GERMAN_RULES
]
_french_rules_c = [
    (g, re.compile((lc or "") + "$") if lc else None,
     re.compile("^" + rc) if rc else None, out)
    for g, lc, rc, out in _FRENCH_RULES
]


def _word_origin(word: str) -> str:
    if _GERMAN_RE.search(word):
        return "de"
    if _FRENCH_RE.search(word):
        return "fr"
    return "en"



_NUCLEUS_VOWELS = "ɑæɔəɛɪʊaeiouɜ"
_DIPHTHONGS = {"eɪ", "aɪ", "ɔɪ", "oʊ", "aʊ"}


def _nucleus_spans(ipa: str):
    """Vowel-nucleus spans [(start, end)] of an IPA string (diphthongs as
    one span)."""
    spans, i = [], 0
    while i < len(ipa):
        if ipa[i] in _NUCLEUS_VOWELS:
            j = i + 1
            if j < len(ipa) and ipa[i : j + 1] in _DIPHTHONGS:
                j += 1
            spans.append((i, j))
            i = j
        else:
            i += 1
    return spans


# ---------------------------------------------------------------------------
# Stress placement from orthography (VERDICT r4 #3). English derivational
# suffixes largely determine stress position; the table maps an
# orthographic suffix to the stressed nucleus counted FROM THE END of the
# IPA our own rules emit for it (1 = the suffix's own final nucleus, 2 =
# the nucleus just before a 1-nucleus suffix, ...). Stress-NEUTRAL
# suffixes are stripped first so "respectfulness" resolves like
# "respect". Without a suffix cue: reducible latinate prefixes throw
# stress to the second nucleus; everything else defaults to the first
# (the majority pattern for dictionary headwords).
# ---------------------------------------------------------------------------

_STRESS_SUFFIXES = [
    # stress on the suffix itself
    ("eer", 1), ("ese", 1), ("ique", 1), ("esce", 1),
    ("ette", 1), ("oon", 1), ("aire", 1), ("eur", 1), ("euse", 1),
    # stress immediately before the suffix (n = suffix nuclei + 1,
    # counted in OUR rule output)
    ("ation", 2), ("ition", 2), ("ution", 2), ("tion", 2), ("sion", 2),
    ("cial", 2), ("tial", 2), ("cious", 2), ("tious", 2), ("geous", 2),
    ("cian", 2), ("gian", 2),
    ("ic", 2), ("ics", 2), ("ical", 3), ("ically", 4),
    ("ity", 3), ("ety", 3), ("ities", 4),
    ("ology", 3), ("ography", 3), ("ogies", 4),
    ("ify", 3), ("efy", 3),
    ("ial", 3), ("ian", 3), ("ious", 3), ("ium", 3), ("ia", 3),
    ("itive", 3), ("itude", 3), ("inal", 3),
    ("self", 1), ("selves", 1),
    # measured against the lexicon's stress marks (suffix_tune):
    ("ual", 3), ("ish", 2), ("ee", 1), ("ade", 1), ("ient", 2),
    # -ate verbs stress the antepenult; listed with their preceding
    # syllable so 2-nuclei words (create, debate) keep final stress
    ("icate", 3), ("igate", 3), ("ulate", 3), ("erate", 3),
    ("inate", 3), ("imate", 3), ("ivate", 3), ("orate", 3),
    # -ence/-ency/-acy put the stress on the antepenult (confidence,
    # efficiency, democracy); 2-nuclei -ense words are spelled 'ense'
    ("ences", 4), ("encies", 4), ("ence", 3), ("ency", 3), ("acy", 3),
    ("ever", 2),  # however, whatever, whenever (clever: 2 nuclei → idx 0)
    # mined from the lexicon's own stress marks (≥88 % consistent, n≥12)
    ("sive", 2), ("onal", 3), ("ion", 2),
    # round-5 second wave, mined the same way (smaller families, 100 %
    # consistent in the lexicon): -ember (september, remember), -ether
    # (together, whether), -ector (director, sector), -ica (america,
    # africa, antarctica; jamaica-type penult stress loses 2:4)
    ("ember", 2), ("ether", 2), ("ector", 2), ("ica", 3),
]

_NEUTRAL_SUFFIX_RE = re.compile(
    r"(ness|less|ment|ful|ship|hood|like|wise|ly|ers?|ings?|ed|es|s)$"
)
_REDUCIBLE_PREFIX_RE = re.compile(
    # net-positive prefixes only, measured against the embedded lexicon's
    # stress marks (pro/ab/sub/pur/for were net-negative; a is +31)
    r"^(?:ex(?=[aiou])|(?:be|de|re|pre|ex|con|com|ad|ob|oc|sup|sur|per|"
    r"en|em|im|in|un|dis|a)(?=[bcdfghjklmnpqrstvwxz]))"
)


def _stress_nucleus(word: str, n_nuclei: int):
    """→ (index into the nucleus-span list of the predicted stressed
    nucleus, prediction source). The source doubles as a confidence tier,
    measured against the embedded lexicon's stress marks: 'suffix' 92 %,
    'default' 81 %, 'prefix' 62 % — the reduction pass scales its
    aggressiveness accordingly (grid-searched per tier)."""
    if n_nuclei <= 1:
        return 0, "default"
    w = word
    for _ in range(3):  # strip stress-neutral suffixes
        for suf, n_end in _STRESS_SUFFIXES:
            if w.endswith(suf) and len(w) - len(suf) >= 2:
                if n_nuclei - n_end < 0:
                    continue  # commence: 2 nuclei can't take the -ence
                    #           antepenult entry — try shorter suffixes
                return n_nuclei - n_end, "suffix"
        w2 = _NEUTRAL_SUFFIX_RE.sub("", w)
        if w2 == w or len(w2) < 3:
            break
        w = w2
    m = _REDUCIBLE_PREFIX_RE.match(w)
    if m and n_nuclei >= 2:
        return 1, "prefix"
    return 0, "default"


def _reduce_unstressed(
    ipa: str, stress_idx: int, word: str = "", source: str = "suffix"
) -> str:
    """Stress-aware vowel reduction: unstressed lax nuclei centralize to ə
    (CMUdict's dominant pattern), the stressed nucleus keeps its full
    quality. Replaces the round-2 blanket pass, whose two failure modes
    were measured as the top LTS confusions: it reduced STRESSED æ/ɑ
    (ə→æ/ɑ, ~390 errors) and left unstressed ɛ/ɪ full (ɛ→ə 277,
    ɪ→ə 463). Diphthongs, r-colored vowels and a word-final i (happy-
    tensing) keep their quality; an unstressed word-final 'iCe'-spelled
    aɪ (office, engine, promise — magic-e overreach) reduces to ə."""
    spans = _nucleus_spans(ipa)
    if len(spans) < 2:
        return ipa
    # ɛ joins the reducible set only when the stress prediction is
    # trustworthy (grid-searched per source tier: reducing ɛ on the 62 %-
    # accurate prefix tier created more ə→ɛ errors than it fixed)
    reducible = "æɑ" if source == "prefix" else "æɑɛ"
    out = list(ipa)
    # final-syllable 'iCe' spellings whose magic-e aɪ is unstressed reduce
    # — but only the endings where CMUdict's reduced form is the majority
    # pattern: -ice (office, service, justice), -ine after g/m/c (engine,
    # famine, medicine), -ite after s/r/n (opposite, favorite, definite).
    # -ide/-ive/-ise/-ize and the rest keep aɪ (provide, divine,
    # realize); stressed finals are protected by stress_idx either way
    final_ice = bool(re.search(r"(ice|[gmc]ine|[srn]ite)s?$", word))
    # unstressed final -ain reduces to ən (mountain, captain, certain);
    # stressed finals (contain, retain — prefix-cued) stay eɪn
    final_ain = word.endswith(("ain", "ains")) and not word.endswith(
        ("omain", "tertain", "aintain", "ustain", "ttain", "omains",
         "tertains", "aintains", "ustains", "ttains")
    )  # mountain/captain/certain reduce; stress-final verbs keep eɪn
    # ɪ before k keeps its quality only in the -ic suffix family
    # (critical, africa → gold ɪk); medial ..ica../..icat.. reduces
    # (america, indicate, medical → gold ək)
    ic_suffix = word.endswith(("ic", "ics", "ical", "ically"))
    for k, (a, b) in enumerate(spans):
        seg = ipa[a:b]
        if k == stress_idx:
            # the orthographic prefix rules (de-/be-/ex-/re-/pre-/se-/
            # con-/com-) emit the REDUCED vowel unconditionally;
            # when the stress prediction lands on syllable 0 the word
            # is not prefix-derived (decade, expert, concept, contract)
            # and the full vowel must come back. Stressed re-/pre- are
            # tense (recent, previous — CMU IY1), the rest lax
            if k == 0:
                if seg == "ə" and word.startswith(("con", "com")):
                    out[a:b] = ["ɑ"]
                elif seg == "ɪ" and word.startswith(("re", "pre")):
                    out[a:b] = ["i"]
                elif seg == "ɪ" and word.startswith(("de", "be", "ex", "se")):
                    out[a:b] = ["ɛ"]
            continue
        if (
            k == 0 and seg == "\u0259" and word.startswith(("con", "com"))
            and len(spans) >= 3 and stress_idx >= 2 and stress_idx % 2 == 0
        ):
            # same secondary-stress parity for the con-/com- prefix rules,
            # which emit \u0259: even distance to the main stress restores \u0251
            # (conversation, combination, consultation \u2014 CMUdict AA2);
            # odd keeps \u0259 (communication, congratulations \u2014 AH0)
            out[a:b] = ["\u0251"]
            continue
        if k == 0 and source == "prefix":
            # the LTS prefix rules (be/de/re/con/a+CV/…) already emit the
            # reduced vowel when the orthographic context supports it; a
            # full vowel surviving them means the 62 %-accurate prefix
            # stress guess is the only evidence — not enough to destroy
            # it (after, example, accept kept their æ wrongly reduced)
            continue
        if k == 0 and seg in "æɑ" and word.endswith(
            ("et", "ets", "eau", "eaus", "eaux")
        ):
            # French-final-stress loans keep the initial vowel's quality
            # (ballet, chateau, plateau, cabaret — CMUdict AE2, not AH0)
            continue
        if (
            seg == "ɑ" and ipa[b : b + 1] == "r"
            and k == len(spans) - 1
            and word.endswith(("ar", "ars"))
            and not word.endswith((
                "uitar", "uitars", "igar", "igars", "adar", "adars",
                "azar", "azars", "atar", "atars", "anmar", "ilar",
                "ilars", "czar", "tsar",
            ))
        ):
            # unstressed final -ar is syllabic ər (dollar, cellar,
            # calendar, oscar — CMUdict ER0); final-stress loans and
            # names keep ɑr (guitar, cigar, radar, qatar, salazar)
            out[a:b] = ["ə"]
            continue
        if ipa[b : b + 1] == "r":
            continue
        if seg in _DIPHTHONGS:
            # unstressed final-syllable aɪ from magic-e 'iCe' spelling
            if seg == "aɪ" and k == len(spans) - 1 and final_ice:
                out[a:b] = ["ə", ""]
            elif seg == "eɪ" and k == len(spans) - 1 and final_ain:
                out[a:b] = ["ə", ""]
            continue
        if k == len(spans) - 1 and seg == "i":
            continue  # happy-tensing: final i stays tense
        if (
            k == len(spans) - 1 and seg == "æ"
            and word.endswith((
                "graph", "graphs", "gram", "grams", "stand", "stands",
                "act", "acts", "ax", "ack", "acks", "amp", "amps",
                "ash", "ank", "anks", "ang",
            ))
        ):
            # heavy final codas carry secondary stress and keep æ
            # (paragraph, telegram, understand, contact — CMUdict AE2)
            continue
        if (
            k == len(spans) - 1 and seg == "ɑ"
            and word.endswith((
                "top", "tops", "pot", "pots", "box", "stock", "spot",
                "drop", "dot", "log", "dog", "job", "shot", "bot",
            ))
        ):
            continue  # compound-final o keeps ɑ (laptop, mailbox)
        if (
            seg == "ɑ" and k == len(spans) - 2
            and word.endswith(("body", "bodies"))
        ):
            # compound -body keeps ɑ under secondary stress (everybody,
            # somebody, anybody — CMUdict B AA2 D IY0)
            continue
        if (
            k == len(spans) - 1 and seg == "ɪ"
            and word.endswith(("ist", "ists", "im", "ims", "it", "its"))
        ):
            # final -ist/-im/-it reduce (artist, victim, profit — CMUdict
            # AH0), unlike the -ing/-ish/-ive finals which keep ɪ
            out[a:b] = ["ə"]
            continue
        if (
            k == 0 and seg == "ɪ" and word.startswith(("de", "ex", "re"))
            and len(spans) >= 3 and stress_idx >= 2 and stress_idx % 2 == 0
        ):
            # the de-/ex- prefix rules emit reduced ɪ unconditionally; an
            # even-distance main stress puts secondary stress back on the
            # prefix syllable (definition, demonstration, explanation —
            # CMUdict EH2), so restore the full ɛ. Odd distance keeps the
            # reduced vowel (development, determination — IH0)
            out[a:b] = ["ɛ"]
            continue
        if seg in reducible:
            if (
                k == 0 and seg in "æɑɛ" and len(spans) >= 3
                and stress_idx >= 2 and stress_idx % 2 == 0
            ):
                # alternating secondary stress: when the main stress sits
                # an EVEN number of syllables after the first, syllable 1
                # carries secondary stress and the æ/ɑ/ɛ keeps its quality
                # (application, afternoon, operation — CMUdict AE2/AA2/
                # EH2, not AH0); an odd distance leaves it in the trough
                # (accommodation AH0). Checked before the e→ɪ branch
                # below so e-initial long words (education) keep ɛ
                continue
            if (
                k == 0 and seg == "ɛ" and word[:1] != "e"
                and re.search(r"^[^aeiouy]+e[^aeiouy]{2}", word)
            ):
                # pretonic ɛ in an orthographically CLOSED first syllable
                # keeps its quality (september, technology, technique —
                # CMUdict EH0); open syllables centralize (together tə-)
                continue
            # initial unstressed e- centralizes to ɪ, not ə (establish,
            # event, eleven — CMUdict IH0)
            if k == 0 and seg == "ɛ" and word[:1] == "e":
                out[a:b] = ["ɪ"]
            else:
                out[a:b] = ["ə"]
        elif (
            seg == "ɪ" and 0 < k < len(spans) - 1
            and (ipa[b : b + 1] != "k" or not ic_suffix)
            and ipa[b : b + 1] != "ŋ"
            and not (
                ipa[b : b + 1] == "z" and word.endswith(("ism", "isms"))
            )
        ):
            # unstressed word-MEDIAL ɪ centralizes (criminal, separate);
            # final-syllable ɪ stays (-ing, -ish, -ive keep ɪ in CMUdict),
            # so does an initial ɪ (the bɪ-/dɪ-/rɪ- prefix rules already
            # emit CMUdict's vowel), and so does ɪ before k (the -ic/-ical
            # suffix family keeps ɪ: critical, africa, identical), and
            # so does ɪ before z (the -ism family: criticism, organism
            # — CMUdict IH0 Z) or before ŋ (washington, -ing- medial)
            out[a:b] = ["ə"]
    return "".join(c for c in out if c)


_NO_REDUCE = frozenset((
    "themselves", "upon", "forgot", "unless", "suggest", "suggests",
    "suggested",
))


def letter_to_sound(word: str) -> str:
    """Rule-based G2P for an OOV word → pre-ipa2 IPA (no stress marks)."""
    word = word.lower()
    origin = _word_origin(word)
    overlay = (
        _german_rules_c if origin == "de"
        else _french_rules_c if origin == "fr" else None
    )
    out = []
    i = 0
    n = len(word)
    while i < n:
        matched = False
        if overlay is not None:
            for g, lc, rc, ipa in overlay:
                if not word.startswith(g, i):
                    continue
                if lc is not None and not lc.search(word[:i]):
                    continue
                if rc is not None and not rc.search(word[i + len(g):]):
                    continue
                out.append(ipa)
                i += len(g)
                matched = True
                break
        if matched:
            continue
        for g, lc, rc, ipa in _compiled_rules:
            if not word.startswith(g, i):
                continue
            if lc is not None and not lc.search(word[:i]):
                continue
            if rc is not None and not rc.search(word[i + len(g):]):
                continue
            out.append(ipa)
            i += len(g)
            matched = True
            break
        if not matched:
            i += 1  # drop unknown characters
    raw = "".join(out)
    if word.endswith("s") and not word.endswith("ss"):
        # the grapheme cascade can emit z after a voiceless coda
        # (likes, hits); assimilate like _plural does
        raw = re.sub("(?<=[ptkfθ])z$", "s", raw)
    if word in _NO_REDUCE:
        return raw
    n_spans = len(_nucleus_spans(raw))
    if origin == "fr" and n_spans >= 2:
        # French loans carry final stress in English (machine, bouquet,
        # chauffeur); high confidence, so the full reduction set applies
        stress_idx, src = n_spans - 1, "suffix"
    else:
        stress_idx, src = _stress_nucleus(word, n_spans)
    return _reduce_unstressed(raw, stress_idx, word, src)


def _add_default_stress(ipa: str, word: str = "") -> str:
    """Place ˈ before the predicted stressed nucleus's onset (suffix-
    aware via _stress_nucleus when the orthography is known; first
    nucleus otherwise — the old CMU-style default)."""
    if "ˈ" in ipa or "ˌ" in ipa:
        return ipa
    spans = _nucleus_spans(ipa)
    if not spans:
        return ipa
    k = 0
    if word:
        k, _ = _stress_nucleus(word, len(spans))
        k = min(k, len(spans) - 1)
    onset = spans[k][0]
    while onset > 0 and ipa[onset - 1] not in VOWELS_IPA:
        onset -= 1
    return ipa[:onset] + "ˈ" + ipa[onset:]


def _plural(base: str) -> str:
    return base + (
        "əz" if base[-1] in "szʃʒʧʤ" else ("s" if base[-1] in "ptkfθ" else "z")
    )


def _past(base: str) -> str:
    return base + (
        "əd" if base[-1] in "td" else ("t" if base[-1] in "pkfθsʃʧ" else "d")
    )


def _stem_candidates(stem: str):
    """Orthographic stems a suffix may have been attached to:
    identity, e-restoration (mak→make), un-doubling (runn→run),
    i→y restoration (studi→study, happi→happy)."""
    yield stem
    yield stem + "e"
    if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] not in "aeiou":
        yield stem[:-1]
    if stem.endswith("i"):
        yield stem[:-1] + "y"


# suffix → function(base_ipa) -> ipa  (ordered longest-first)
_SUFFIX_RULES = [
    ("'s", _plural),
    ("ments", lambda b: _plural(b + "mənt")),
    ("ness", lambda b: b + "nəs"),
    ("ment", lambda b: b + "mənt"),
    ("less", lambda b: b + "ləs"),
    ("ful", lambda b: b + "fəl"),
    ("able", lambda b: b + "əbəl"),
    ("ably", lambda b: b + "əbli"),
    ("ings", lambda b: _plural(b + "ɪŋ")),
    ("ing", lambda b: b + "ɪŋ"),
    ("ers", lambda b: _plural(b + "ər")),
    ("est", lambda b: b + "əst"),
    ("er", lambda b: b + "ər"),
    ("ed", _past),
    ("ly", lambda b: (b[:-1] if b.endswith("l") else b) + "li"),
    ("es", _plural),
    ("s", _plural),
    ("ish", lambda b: b + "ɪʃ"),
    ("en", lambda b: b + "ən"),
    ("y", lambda b: b + "i"),
    ("n", lambda b: b + "n"),
]

# prefix → ipa prefix (attached to an independently-resolvable remainder)
_PREFIX_RULES = [
    ("counter", "ˌkaʊntər"), ("under", "ˌəndər"), ("inter", "ˌɪntər"),
    ("over", "ˌoʊvər"), ("super", "ˌsupər"), ("multi", "ˌməlti"),
    ("anti", "ˌænti"), ("semi", "ˌsɛmi"), ("trans", "trænz"),
    ("micro", "ˌmaɪkroʊ"), ("ultra", "ˌəltrə"), ("non", "nɑn"),
    ("out", "ˌaʊt"), ("mis", "mɪs"), ("pre", "pri"), ("sub", "səb"),
    ("dis", "dɪs"), ("un", "ən"), ("re", "ri"), ("co", "koʊ"),
    ("de", "di"),
]


def _lookup(word: str, depth: int = 0):
    """Lexicon lookup with morphological decomposition. Returns IPA or
    None (→ caller falls back to letter-to-sound)."""
    if word in LEXICON:
        return LEXICON[word]
    if depth >= 3 or len(word) < 3:
        return None

    for suffix, attach in _SUFFIX_RULES:
        if not word.endswith(suffix) or len(word) - len(suffix) < 2:
            continue
        for stem in _stem_candidates(word[: -len(suffix)]):
            base = LEXICON.get(stem)
            if base is None and depth == 0:
                base = _lookup(stem, depth + 1)
            if base is not None:
                return attach(base)

    for prefix, ipa in _PREFIX_RULES:
        if word.startswith(prefix) and len(word) - len(prefix) >= 3:
            rest = _lookup(word[len(prefix):], depth + 1)
            if rest is not None:
                return ipa + rest.replace("ˈ", "" if "ˈ" in ipa else "ˈ")

    # closed compounds: both halves independently resolvable
    if depth == 0 and len(word) >= 6:
        for cut in range(len(word) - 2, 2, -1):
            left, right = word[:cut], word[cut:]
            if left in LEXICON and len(right) >= 3:
                r = _lookup(right, depth + 1)
                if r is not None:
                    return LEXICON[left] + r.replace("ˈ", "ˌ")
    return None


def _hybrid_compound(word: str):
    """Half-lexicon compounds for the true OOV tail (brexiteers,
    cyberattack): one half resolves through the lexicon, the other
    through letter-to-sound. Tried only after full _lookup fails — a
    correct lexicon half beats running the rules over the whole word.
    Requires halves >= 4 letters so short accidental splits (e.g.
    'ing'-like tails) don't fire."""
    if len(word) < 8:
        return None
    for cut in range(len(word) - 4, 3, -1):
        left, right = word[:cut], word[cut:]
        lf, rt = _lookup(left, 1), _lookup(right, 1)
        if lf is not None and rt is None:
            return lf + letter_to_sound(right)
        if lf is None and rt is not None:
            return letter_to_sound(left) + rt.replace("ˈ", "ˌ")
    return None


def is_oov(word: str) -> bool:
    """True when the word falls through to rule-based letter-to-sound."""
    return _lookup(word.lower()) is None


def word_to_ipa(word: str) -> str:
    w = word.lower()
    found = _lookup(w)
    if found is not None:
        return found
    hybrid = _hybrid_compound(w)
    if hybrid is not None:
        return _add_default_stress(hybrid)
    ipa = letter_to_sound(w)
    return _add_default_stress(ipa, w)


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def ascii_fold(text: str) -> str:
    """Strip diacritics / transliterate to ASCII (lightweight unidecode)."""
    normalized = unicodedata.normalize("NFKD", text)
    return "".join(
        c for c in normalized if not unicodedata.combining(c) and ord(c) < 128
    )


def collapse_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text)


_word_re = re.compile(r"[a-z']+|[^a-z'\s]+|\s+")


def english_to_ipa(text: str) -> str:
    text = ascii_fold(text).lower()
    text = expand_abbreviations(text)
    text = normalize_numbers(text)
    pieces = []
    for m in _word_re.finditer(text):
        tok = m.group(0)
        if re.fullmatch(r"[a-z']+", tok):
            pieces.append(word_to_ipa(tok))
        else:
            pieces.append(tok)
    return collapse_whitespace("".join(pieces))


def mark_dark_l(text: str) -> str:
    # reference: utils/g2p/english.py:155-156
    return re.sub(
        r"l([^aeiouæɑɔəɛɪʊ ]*(?: |$))", lambda x: "ɫ" + x.group(1), text
    )


_ipa_to_ipa2 = [("r", "ɹ"), ("ʤ", "dʒ"), ("ʧ", "tʃ")]


def english_to_ipa2(text: str) -> str:
    text = english_to_ipa(text)
    text = mark_dark_l(text)
    for pat, repl in _ipa_to_ipa2:
        text = text.replace(pat, repl)
    return text.replace("...", "…")
