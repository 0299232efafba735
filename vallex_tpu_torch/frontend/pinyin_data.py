"""Embedded hanzi → pinyin data.

The reference uses the `pypinyin` package (utils/g2p/mandarin.py:244), which
is not available in this image, so a character→reading table for common hanzi
is embedded here, plus a word-level override dict for frequent polyphones
(多音字). Readings use numeric-tone pinyin (1-4, 5 = neutral), 'v' for ü.

Coverage targets everyday Mandarin text; characters outside the table are
passed through unchanged (they then fall into the latin/punctuation path of
the cleaner, mirroring the reference's behavior for unknown input).
"""

from __future__ import annotations

from typing import Dict, List, Optional

# Format: "pinyin:chars" — every char in `chars` reads as `pinyin`.
_DATA = """
de5:的
le5:了
shi4:是事世士市示视试室势適释饰氏逝誓嗜柿拭轼
yi1:一衣医依伊壹揖
yi2:宜移疑遗仪姨夷胰怡贻彝
yi3:以已椅乙蚁倚矣
yi4:意义议易亿艺译异益忆疫役亦翼谊毅逸溢忆抑邑裔翌弈奕
bu4:不部布步怖簿埠
ta1:他她它塔踏
men5:们
wo3:我
zai4:在再
you3:有友酉
you4:又右幼诱佑柚
you1:优忧悠幽
you2:由游油邮尤犹铀鱿
zhe4:这浙
zhong1:中忠钟终衷盅
zhong4:众重种仲
zhong3:肿
da4:大
lai2:来莱
shang4:上尚
guo2:国
ge4:个各
dao4:到道倒盗悼稻
shuo1:说
ni3:你拟妮
ren2:人仁
nian2:年粘
jiu4:就旧救舅臼咎
chu1:出初
hui4:会惠慧汇绘贿烩讳
hui2:回茴
hui1:灰挥辉恢徽
ye3:也野冶
dui4:对队兑
sheng1:生声升牲甥笙
neng2:能
er2:而儿
er3:尔耳饵
er4:二贰
xia4:下夏吓厦
zi4:自字
zi3:子仔籽紫姊梓
zhi1:之只知支枝芝织肢汁吱脂蜘
zhi2:直值职植执殖侄
zhi3:指止纸址旨趾咫
zhi4:至制治志质致智置秩帜滞稚挚掷窒炙痔
guo4:过
jia1:家加佳嘉夹茄
jia4:价架驾嫁稼
jia3:甲假贾钾
xue2:学穴
shi2:十时实识石食拾蚀什
shi3:使史始驶矢屎
shi1:师诗失施湿狮尸
hao3:好
hao4:号浩耗皓
kan4:看
qi3:起启企岂乞
qi2:其奇齐骑棋旗祈歧脐崎
qi1:七期欺漆妻戚柒沏
qi4:气汽器弃泣契砌
tian1:天添
xiao3:小晓
me5:么
qu4:去趣
ne5:呢
hai2:还孩
hai3:海
hai4:害亥骇
ma1:妈
ma5:吗嘛
yao4:要药耀钥
yao2:摇遥窑谣姚
yao1:腰邀妖夭
dou1:都兜
dou4:豆斗逗痘
dao3:导岛倒捣祷蹈
xiang3:想响享
xiang1:相香乡箱厢湘镶
xiang4:向象像项巷橡
zuo4:作做坐座
zuo2:昨
zuo3:左佐
li3:里理李礼鲤裏
li4:力立利历例丽励粒厉莉荔栗吏沥痢
li2:离梨狸璃篱黎犁厘
na4:那纳钠娜
na3:哪
kai1:开揩
guan1:关观官冠棺
guan3:管馆
guan4:惯灌罐贯
men2:门
jian4:见件建健剑荐键舰渐鉴箭践
jian1:间坚肩兼监尖奸煎
jian3:简减检剪捡拣碱茧
wei4:为位未味卫谓喂胃魏慰尉
wei2:围维违唯惟帷
wei3:伟委伪尾纬萎
wei1:威微危巍偎
dian4:电店殿垫淀奠佃
dian3:点典碘
zhu4:住注助主筑祝铸驻柱蛀贮
zhu3:主煮嘱瞩
zhu1:猪珠朱株诸蛛
zhu2:竹逐烛
fa1:发
fa3:法
fa2:罚乏伐阀筏
fang1:方芳坊
fang4:放
fang2:房防妨肪
fang3:访纺仿彷
suo3:所索锁
xin1:心新辛欣薪馨芯锌
xing2:行形型刑
xing4:性姓幸杏兴
xing1:星腥猩
xing3:醒
ming2:明名鸣铭冥茗
li5:哩
hou4:后候厚侯
qian2:前钱潜乾
qian1:千签牵铅谦迁
qian3:浅遣
zui4:最罪醉
ti3:体
ti2:题提蹄啼
ti4:替剃惕涕屉
xian4:现线限县献宪陷馅羡腺
xian1:先仙鲜掀纤
xian3:险显
ying1:应英樱鹰婴鹦
ying2:营迎赢盈蝇萤荧
ying3:影颖
ying4:映硬
gong1:工公功攻供宫恭躬弓
gong4:共贡
xie1:些楔
xie4:谢卸泄泻屑械懈蟹
xie3:写血
xie2:鞋协斜携邪胁谐
bian4:变便遍辩辨辫
bian1:边编鞭蝙
bian3:扁贬
shou3:手首守
shou4:受售授寿瘦兽
shou1:收
jiao4:叫教较觉校轿酵
jiao1:交教郊浇娇骄胶椒焦蕉礁
jiao3:角脚搅饺缴绞狡
wen4:问
wen2:文闻纹蚊
wen3:稳吻紊
ke3:可渴坷
ke4:课克客刻克恪
ke1:科棵颗柯磕蝌
ke2:壳咳
bei4:被备倍背贝辈悲惫狈焙
bei1:杯悲碑卑
bei3:北
jin4:进近尽劲禁晋浸
jin1:今金斤筋津襟
jin3:紧仅谨锦
gao1:高糕膏羔
gao4:告
gao3:搞稿
san1:三叁
ji2:级即急集极籍吉疾嫉辑棘
ji1:机基击积鸡迹肌饥姬讥矶唧缉
ji3:几己挤脊戟
ji4:记计济技际纪继寄季既祭剂悸讳髻忌
zhang1:张章彰樟
zhang3:长涨掌
zhang4:丈帐障仗胀账杖
ba3:把靶
ba4:爸坝罢霸
ba1:八巴吧芭疤笆捌
ba5:吧罢
ceng2:曾层
ceng4:蹭
liang3:两俩
liang4:量亮辆谅晾
liang2:良凉梁粮粱
gei3:给
cong2:从丛
zhao3:找沼爪
zhao4:照赵罩兆召肇
zhao1:招朝昭
dan4:但蛋旦淡氮弹诞惮
dan1:单担丹耽
dan3:胆
duo1:多哆
duo2:夺
duo3:朵躲
er5:儿
fen1:分份纷芬吩氛
fen4:份奋愤粪忿
fen3:粉
fei1:非飞菲啡妃绯
fei4:费废肺沸痱
fei2:肥
pang2:旁庞螃
zou3:走
qing3:请
qing1:清青轻倾卿氢蜻
qing2:情晴擎
qing4:庆
zhen1:真针珍贞侦斟榛
zhen4:阵镇震振赈
zhen3:诊枕
yang4:样漾
yang2:阳洋羊杨扬疡
yang3:养氧仰痒
yang1:央秧殃
jiang1:将江姜浆僵疆
jiang3:讲奖桨蒋
jiang4:降酱匠将
gen1:根跟
gen2:哏
hen3:很狠
hen4:恨
tong2:同铜童桐瞳彤
tong1:通
tong3:统桶筒捅
tong4:痛
mei2:没煤眉梅媒霉玫枚酶
mei3:美每镁
mei4:妹魅媚
kan1:刊堪勘
ban4:办半伴拌扮瓣绊
ban1:班般搬斑颁扳
ban3:板版
chang2:常长场尝肠偿裳
chang3:场厂敞
chang4:唱畅倡
chang1:昌猖
qu1:区曲驱屈躯趋
qu2:渠
qu3:取曲娶
ran2:然燃
rang4:让
re4:热惹
ri4:日
rong2:容荣融溶绒熔蓉
ru2:如儒
ru4:入褥
ruo4:若弱
sai4:赛
se4:色涩瑟
sha1:杀沙纱刹砂鲨煞
shan1:山删衫珊煽扇
shan4:善扇擅膳赡
shao3:少
shao4:少绍哨
shao1:烧稍捎梢
she4:社设射摄涉舍赦
she2:蛇舌折
she3:舍
shen1:身深申伸绅呻
shen2:什神
shen3:审沈婶
shen4:甚肾慎渗
sheng4:胜圣盛剩
sheng3:省
sheng2:绳
shu1:书输舒叔殊梳疏蔬抒
shu4:数术树束述竖恕墅漱
shu3:数属鼠暑署薯曙
shu2:熟赎
shui3:水
shui4:睡税
shui2:谁
si1:思私司丝斯撕嘶厮
si3:死
si4:四似寺肆饲伺
song4:送宋诵颂讼
song1:松
su4:素速诉宿肃塑溯
su1:苏酥
suan4:算蒜
suan1:酸
sui4:岁碎遂隧穗
sui2:随
sui1:虽
sun1:孙
suo1:缩梭唆
tai4:太态泰汰
tai2:台抬苔
tan2:谈弹坛痰潭檀
tan4:探叹炭碳
tan1:贪摊滩瘫
tang2:堂糖唐塘膛
tang1:汤
tang3:躺倘
tao4:套
tao2:逃桃陶淘萄
tao3:讨
te4:特
teng2:疼腾藤誊
ti1:梯踢剔
tian2:田甜填
tiao2:条调
tiao4:跳眺
tiao1:挑
tie1:贴
tie3:铁帖
ting1:听厅
ting2:停庭亭廷蜓
ting3:挺艇
tou2:头投
tou4:透
tou1:偷
tu2:图途涂徒屠
tu3:土吐
tu4:兔吐
tuan2:团
tui1:推
tui3:腿
tui4:退褪
tun1:吞
tuo1:脱托拖
tuo2:驼驮鸵
wa1:挖蛙洼哇
wai4:外
wan2:完玩丸顽
wan3:晚碗挽惋婉
wan4:万腕
wang2:王亡
wang3:往网枉
wang4:忘望旺妄
wu2:无吴梧
wu3:五午舞武伍侮捂
wu4:物务误悟雾勿恶戊
wu1:屋乌污巫呜诬
xi1:西希吸息悉析稀溪锡牺晰熄膝嘻惜昔
xi2:习席袭媳
xi3:洗喜
xi4:系细戏隙
xia1:虾瞎
xia2:霞峡狭暇辖侠
xian2:闲贤弦咸嫌衔
xiao4:笑效孝肖啸
xiao1:消销萧宵削硝潇
xin4:信
xiong1:兄胸凶汹
xiong2:雄熊
xiu1:修休羞
xiu4:秀绣袖嗅锈
xu1:需须虚嘘墟
xu3:许
xu4:续序绪蓄叙畜酗絮
xuan3:选
xuan1:宣喧
xuan2:旋悬玄
xuan4:旋眩绚炫
xun2:寻询巡循旬
xun4:训迅讯逊驯汛
ya1:压鸭押
ya2:牙芽崖涯蚜
ya3:雅哑
ya4:亚轧
yan2:言严沿研盐颜岩炎延艳阎沿蜒
yan3:眼演掩衍
yan4:验宴艳焰雁燕咽厌砚唁
yan1:烟淹咽腌
ye4:业夜叶页液腋
ye1:椰噎
ye2:爷
yin1:因音阴姻荫
yin2:银吟寅淫
yin3:引饮隐瘾
yin4:印
yong4:用
yong3:永勇涌泳咏踊
yong1:拥庸佣
yu2:于余鱼渔娱愉愚舆渝逾隅
yu3:与雨语宇羽屿禹
yu4:育玉遇域欲狱预誉愈郁寓裕浴御狱
yu1:迂淤
yuan2:员元原园圆源缘援猿袁辕
yuan4:院愿怨苑
yuan3:远
yuan1:冤鸳渊
yue4:月越阅跃悦岳粤
yue1:约曰
yun2:云匀
yun4:运韵孕酝晕
yun1:晕
za2:杂砸
zan2:咱
zang4:藏脏葬
zang1:脏赃
zao3:早澡枣蚤
zao4:造燥灶躁皂噪
zao1:遭糟
ze2:则责泽择
zen3:怎
zeng1:增曾憎
zeng4:赠
zha4:炸诈榨乍栅
zha1:扎渣查
zhai4:债寨
zhai1:摘斋
zhan4:站战占栈绽蘸
zhan3:展斩崭盏
zhan1:沾粘瞻占
zhei4:这
zheng4:正政证症郑挣
zheng1:争征蒸睁挣狰筝
zheng3:整拯
zhou1:周州舟洲粥
zhou4:宙皱骤昼咒
zhou3:肘帚
zhuan3:转
zhuan4:转赚传撰
zhuan1:专砖
zhuang4:状壮撞幢
zhuang1:装庄桩妆
zhun3:准
zhuo1:桌捉拙
zhuo2:着浊酌啄琢灼茁
zong3:总
zong1:宗棕踪综鬃
zu2:足族
zu3:组阻祖
zu1:租
zui3:嘴
zun1:尊遵
zun3:撙
cai2:才财材裁
cai3:采彩踩睬
cai4:菜蔡
cai1:猜
can1:参餐
can2:残蚕惭
can3:惨
can4:灿
cao3:草
cao1:操糙
ce4:测册侧厕策
cha2:查茶察搽
cha4:差岔诧刹
cha1:差插叉
chai1:拆差
chan3:产铲阐
chan2:缠蝉馋禅
chao1:超抄钞
chao2:朝潮巢嘲
chao3:吵炒
che1:车
che4:彻撤澈扯
chen2:陈沉晨尘臣辰
chen4:衬趁称
cheng2:成城程诚承乘盛橙呈惩澄
cheng1:称撑
cheng4:秤
chi1:吃痴嗤
chi2:持迟池驰匙
chi3:尺齿耻侈
chi4:赤斥翅炽
chou1:抽
chou2:愁仇绸稠筹酬踌
chou3:丑
chou4:臭
chu2:除厨锄雏橱
chu3:处楚础储
chu4:处触畜
chuan2:传船
chuan1:穿川
chuan3:喘
chuan4:串
chuang1:窗疮
chuang2:床
chuang4:创
chuang3:闯
chui1:吹炊
chui2:垂锤捶
chun1:春
chun2:纯唇醇
ci2:词辞慈磁雌瓷
ci3:此
ci4:次刺赐伺
cu1:粗
cu4:促醋簇
cuan4:窜篡
cui1:催摧
cui4:脆翠粹萃
cun2:存
cun1:村
cuo4:错措挫
cuo1:搓磋
ai4:爱碍艾暧
ai1:哀埃挨唉哎
ai2:挨癌
an1:安鞍氨庵
an4:案按暗岸
ang2:昂
ao4:奥傲澳懊
ao2:熬遨翱
pa4:怕帕
pa2:爬扒
pai2:排牌徘
pai4:派
pai1:拍
pan4:判盼叛畔
pan2:盘磐
pan1:攀潘
pao3:跑
pao4:炮泡
pao1:抛
pao2:袍刨咆
pei2:陪培赔
pei4:配佩沛
pen2:盆
pen1:喷
peng2:朋棚蓬彭膨硼
peng4:碰
peng3:捧
pi2:皮疲脾啤琵
pi1:批披霹劈坯
pi4:僻譬屁辟
pi3:匹劈痞
pian4:片骗
pian1:篇偏
pian2:便
piao4:票漂
piao1:飘漂
piao2:瓢嫖
pin1:拼
pin3:品
pin2:贫频聘
pin4:聘
ping2:平评瓶凭萍屏苹
po4:破迫魄
po1:坡泼颇
po2:婆
pu3:普谱朴浦
pu1:扑铺仆
pu2:葡菩仆
pu4:铺瀑
mai3:买
mai4:卖麦迈脉
man3:满
man4:慢漫曼蔓幔
man2:瞒蛮馒埋
mang2:忙盲茫芒氓
mao2:毛矛茅锚髦
mao4:贸冒帽茂貌
mao1:猫
miao4:妙庙
miao2:苗描瞄
miao3:秒渺藐
mian4:面
mian3:免勉缅冕娩
mian2:棉眠绵
min2:民
min3:敏
mo4:末莫墨默漠陌寞沫
mo2:模磨摩膜魔蘑摸
mou3:某
mou2:谋牟
mu4:目木幕墓慕牧募睦穆
mu3:母亩姆拇
nan2:南难男
nan4:难
nao3:脑恼
nao4:闹
nei4:内
ni2:泥尼呢霓
ni4:逆腻匿溺
nin2:您
niu2:牛
niu3:扭纽钮
nong2:农浓脓
nong4:弄
nu3:努
nu4:怒
nv3:女
nuan3:暖
o1:噢
ou1:欧鸥殴
ou3:偶呕藕
pa1:趴啪
lan2:蓝兰栏拦篮澜
lan3:览懒缆揽
lan4:烂滥
lang2:狼郎廊榔
lang4:浪
lao3:老
lao2:劳牢捞唠
lao4:涝烙
lei4:类泪累
lei2:雷
lei3:累垒蕾
leng3:冷
leng4:愣
lian2:连联莲廉帘怜涟镰
lian4:练炼恋链
lian3:脸敛
liao3:了
liao4:料廖镣
liao2:聊疗辽僚缭
lie4:列烈裂劣猎
lin2:林临邻琳磷淋鳞霖
lin4:吝赁
ling2:灵零铃龄凌陵玲菱伶
ling3:领岭
ling4:另令
liu2:流留刘榴瘤硫
liu4:六遛
liu3:柳
long2:龙隆笼聋窿
long3:垄拢笼
lou2:楼
lou4:漏陋露
lu4:路录陆露鹿碌赂
lu2:炉芦庐卢颅
lu3:鲁虏掳卤
lv4:律绿率虑滤氯
lv3:旅吕铝屡缕履侣
lv2:驴
luan4:乱
luan3:卵
lun4:论
lun2:轮伦沦仑囵
luo4:落络骆洛
luo2:罗锣箩萝螺逻骡
luo3:裸
ka1:咖喀
ka3:卡
kang4:抗炕
kang1:康慷糠
kang2:扛
kao3:考烤拷
kao4:靠
ken3:肯恳啃垦
kong1:空
kong3:恐孔
kong4:控空
kou3:口
kou4:扣寇叩
ku1:哭枯窟
ku3:苦
ku4:库裤酷
kua1:夸
kua4:跨挎胯
kuai4:快块会筷脍
kuan1:宽
kuan3:款
kuang4:况矿框旷眶
kuang2:狂
kuang1:筐
kui1:亏盔窥
kui4:愧馈溃
kun4:困
kun1:昆坤
kuo4:扩括阔廓
ha1:哈
han4:汉汗旱憾撼翰焊
han2:含寒韩涵函
han3:喊罕
hang2:行航杭
hang4:巷
hao2:豪毫嚎壕
he2:和合河何核荷盒贺禾
he1:喝呵
he4:贺赫鹤吓喝
hei1:黑嘿
heng2:横衡恒
hong2:红洪宏虹鸿
hong1:轰烘
hong4:哄
hu4:户护互沪
hu2:湖胡糊壶蝴狐弧葫
hu1:呼忽乎唿
hua4:话化画划华桦
hua2:华划滑猾哗
hua1:花哗
huai4:坏
huai2:怀淮徊槐
huan1:欢
huan2:还环
huan4:换患幻唤焕痪宦
huan3:缓
huang2:黄皇煌蝗凰惶
huang1:荒慌
huang3:谎晃恍
huang4:晃
jie2:节结洁杰捷截竭劫睫
jie1:接街阶皆揭
jie3:解姐
jie4:界介借戒届藉芥
ju4:句据具剧聚巨俱距惧拒锯
ju2:局菊橘
ju1:居车拘鞠驹
ju3:举沮咀矩
juan4:卷倦眷绢
juan1:捐娟鹃圈
juan3:卷
jue2:决觉绝掘诀倔爵嚼
jun1:军均君钧菌
jun4:俊峻竣骏
ga1:嘎
gai1:该
gai3:改
gai4:盖概钙溉
gan3:感敢赶秆橄
gan4:干
gan1:干甘肝杆竿尴
gang1:刚钢纲缸冈肛
gang3:港岗
ge1:歌哥割搁胳鸽咯疙
ge2:格革隔阁葛膈
ge3:葛
gou4:够构购
gou1:沟钩勾
gou3:狗苟
gu4:故顾固雇
gu3:古股骨谷鼓估蛊贾
gu1:姑孤辜菇咕箍
gua1:瓜刮呱
gua4:挂卦褂
guai4:怪
guai1:乖
guai3:拐
gui1:规归龟硅闺瑰
gui4:贵桂柜跪刽
gui3:鬼轨诡
gun3:滚
gun4:棍
deng3:等
deng1:登灯
deng4:邓瞪凳
di4:地第弟帝递缔蒂
di1:低滴堤提
di2:敌笛迪涤嫡
di3:底抵诋邸
du4:度杜肚渡妒镀
du2:读独毒
du3:堵赌睹
du1:都督嘟
duan4:段断锻缎
duan3:短
duan1:端
dui1:堆
dun4:顿盾钝炖
dun1:吨蹲墩
dong1:东冬
dong4:动洞冻栋
dong3:懂董
da2:答达
da3:打
da1:搭嗒
dai4:带代待戴袋贷逮怠
dai1:呆待
dai3:歹逮
cang2:藏
cang1:仓苍舱沧
bao4:报抱暴爆鲍刨
bao3:保宝饱堡
bao1:包胞苞褒剥
bao2:薄雹
bi3:比笔彼鄙
bi4:必毕币避闭壁臂弊碧蔽毙痹辟庇璧
bi1:逼
bi2:鼻
biao3:表
biao1:标彪膘
bie2:别
bing4:病并
bing1:兵冰
bing3:丙柄饼秉
bo1:波播拨剥玻菠钵
bo2:博伯脖泊勃舶薄驳搏膊柏礴
bai3:百摆柏伯佰
bai2:白
bai4:败拜呗
bang1:帮邦梆
bang4:棒磅镑傍谤蚌
bang3:绑榜膀
beng2:甭
beng4:蹦迸泵
beng1:崩绷
bin1:宾滨彬缤
bin4:鬓殡
nai3:奶乃
nai4:耐奈
nao2:挠
nen4:嫩
ni1:妮
nian1:蔫
rou4:肉
rou2:揉柔
ren4:认任刃韧纫
ren3:忍
reng4:扔
ri4:日
zhe5:着
zhe2:折哲辙蜇
zhe3:者
pie1:瞥撇
pie3:撇
pou1:剖
nuo4:诺糯懦
nve4:虐疟
lve4:略掠
jue1:撅
ken4:裉
zhei4:这
zhuai4:拽
zhua1:抓
shua1:刷
shua3:耍
shuan4:涮
chuai1:揣
cou4:凑
diu1:丢
fou3:否
fu4:付父负副富复妇附赴傅腹覆赋缚咐讣阜驸
fu2:福服浮扶符幅伏俘拂袱氟苻
fu3:府腐辅抚斧俯脯釜腑
fu1:夫肤敷孵呋
ha2:蛤
ka3:卡咯
keng1:坑吭
kua3:垮
kuai3:蒯
lia3:俩
lo5:咯
lou1:搂
lou3:篓搂
mai2:埋霾
miu4:谬
mo1:摸
nang2:囊
o2:哦
ou4:怄
pei1:胚呸
shai3:色
shei2:谁
zan1:簪
zei2:贼
zhui1:追锥
zhui4:坠缀赘
zhun1:谆
zan3:攒
zhai3:窄
zhai2:宅择
"""

# Word-level overrides for frequent polyphones (checked before per-char).
WORD_OVERRIDES: Dict[str, List[str]] = {
    "挑战": ["tiao3", "zhan4"],
    "挑衅": ["tiao3", "xin4"],
    "调查": ["diao4", "cha2"],
    "调整": ["tiao2", "zheng3"],
    "调节": ["tiao2", "jie2"],
    "空调": ["kong1", "tiao2"],
    "强调": ["qiang2", "diao4"],
    "音乐": ["yin1", "yue4"],
    "乐器": ["yue4", "qi4"],
    "快乐": ["kuai4", "le4"],
    "乐观": ["le4", "guan1"],
    "觉得": ["jue2", "de5"],
    "睡觉": ["shui4", "jiao4"],
    "还是": ["hai2", "shi4"],
    "还有": ["hai2", "you3"],
    "归还": ["gui1", "huan2"],
    "便宜": ["pian2", "yi5"],
    "方便": ["fang1", "bian4"],
    "重要": ["zhong4", "yao4"],
    "重复": ["chong2", "fu4"],
    "重新": ["chong2", "xin1"],
    "种植": ["zhong4", "zhi2"],
    "得到": ["de2", "dao4"],
    "觉悟": ["jue2", "wu4"],
    "干活": ["gan4", "huo2"],
    "干部": ["gan4", "bu4"],
    "首都": ["shou3", "du1"],
    "都市": ["du1", "shi4"],
    "处理": ["chu3", "li3"],
    "相处": ["xiang1", "chu3"],
    "处于": ["chu3", "yu2"],
    "长大": ["zhang3", "da4"],
    "成长": ["cheng2", "zhang3"],
    "长辈": ["zhang3", "bei4"],
    "校长": ["xiao4", "zhang3"],
    "增长": ["zeng1", "zhang3"],
    "不是": ["bu2", "shi4"],
    "一个": ["yi2", "ge4"],
    "一样": ["yi2", "yang4"],
    "一起": ["yi4", "qi3"],
    "一些": ["yi4", "xie1"],
    "一切": ["yi2", "qie4"],
    "一下": ["yi2", "xia4"],
    "银行": ["yin2", "hang2"],
    "行业": ["hang2", "ye4"],
    "行长": ["hang2", "zhang3"],
    "长大": ["zhang3", "da4"],
    "成长": ["cheng2", "zhang3"],
    "重要": ["zhong4", "yao4"],
    "重新": ["chong2", "xin1"],
    "重复": ["chong2", "fu4"],
    "音乐": ["yin1", "yue4"],
    "快乐": ["kuai4", "le4"],
    "乐趣": ["le4", "qu4"],
    "觉得": ["jue2", "de5"],
    "睡觉": ["shui4", "jiao4"],
    "还是": ["hai2", "shi4"],
    "还有": ["hai2", "you3"],
    "还原": ["huan2", "yuan2"],
    "得到": ["de2", "dao4"],
    "得意": ["de2", "yi4"],
    "便宜": ["pian2", "yi5"],
    "方便": ["fang1", "bian4"],
    "东西": ["dong1", "xi5"],
    "喜欢": ["xi3", "huan5"],
    "地方": ["di4", "fang5"],
    "知道": ["zhi1", "dao4"],
    "什么": ["shen2", "me5"],
    "怎么": ["zen3", "me5"],
    "为了": ["wei4", "le5"],
    "因为": ["yin1", "wei4"],
    "为什么": ["wei4", "shen2", "me5"],
    "行为": ["xing2", "wei2"],
    "认为": ["ren4", "wei2"],
    "以为": ["yi3", "wei2"],
    "朝阳": ["chao2", "yang2"],
    "朝鲜": ["chao2", "xian3"],
    "干净": ["gan1", "jing4"],
    "干部": ["gan4", "bu4"],
    "身长": ["shen1", "chang2"],
    "首都": ["shou3", "du1"],
    "都市": ["du1", "shi4"],
    "教师": ["jiao4", "shi1"],
    "教学": ["jiao1", "xue2"],
    "数学": ["shu4", "xue2"],
    "数数": ["shu3", "shu4"],
    "处理": ["chu3", "li3"],
    "到处": ["dao4", "chu4"],
    "好处": ["hao3", "chu4"],
    "爱好": ["ai4", "hao4"],
    "只有": ["zhi3", "you3"],
    "一只": ["yi4", "zhi1"],
    "调查": ["diao4", "cha2"],
    "调整": ["tiao2", "zheng3"],
    "空气": ["kong1", "qi4"],
    "有空": ["you3", "kong4"],
    "种植": ["zhong4", "zhi2"],
    "发现": ["fa1", "xian4"],
    "头发": ["tou2", "fa4"],
    "理发": ["li3", "fa4"],
    "假如": ["jia3", "ru2"],
    "放假": ["fang4", "jia4"],
    "答应": ["da1", "ying5"],
    "回答": ["hui2", "da2"],
    "弹钢琴": ["tan2", "gang1", "qin2"],
    "子弹": ["zi3", "dan4"],
    "勉强": ["mian3", "qiang3"],
    "强大": ["qiang2", "da4"],
    "我们": ["wo3", "men5"],
    "你们": ["ni3", "men5"],
    "他们": ["ta1", "men5"],
    "她们": ["ta1", "men5"],
    "它们": ["ta1", "men5"],
    "人们": ["ren2", "men5"],
    "尝试": ["chang2", "shi4"],
    "了解": ["liao3", "jie3"],
    "了不起": ["liao3", "bu4", "qi3"],
    "受不了": ["shou4", "bu4", "liao3"],
    "处理": ["chu3", "li3"],
    "处于": ["chu3", "yu2"],
    "好处": ["hao3", "chu4"],
    "到处": ["dao4", "chu4"],
    "长度": ["chang2", "du4"],
    "都是": ["dou1", "shi4"],
    "首都": ["shou3", "du1"],
    "发现": ["fa1", "xian4"],
    "头发": ["tou2", "fa5"],
    "教学": ["jiao4", "xue2"],
    "教师": ["jiao4", "shi1"],
    "教书": ["jiao1", "shu1"],
    "干净": ["gan1", "jing4"],
    "干活": ["gan4", "huo2"],
    "干部": ["gan4", "bu4"],
}

_EXTRA_CHARS = {
    "您": "nin2", "琴": "qin2", "强": "qiang2", "切": "qie1", "且": "qie3",
    "亲": "qin1", "寝": "qin3", "秦": "qin2", "勤": "qin2", "侵": "qin1",
    "球": "qiu2", "求": "qiu2", "秋": "qiu1", "丘": "qiu1", "泉": "quan2",
    "全": "quan2", "权": "quan2", "劝": "quan4", "券": "quan4", "圈": "quan1",
    "犬": "quan3", "缺": "que1", "却": "que4", "确": "que4", "雀": "que4",
    "裙": "qun2", "群": "qun2", "妙": "miao4", "灭": "mie4", "蔑": "mie4",
    "乜": "mie1", "饶": "rao2", "扰": "rao3", "绕": "rao4", "仍": "reng2",
    "扔": "reng1", "扇": "shan4", "伤": "shang1", "商": "shang1",
    "赏": "shang3", "晌": "shang3", "稍": "shao1", "勺": "shao2",
    "奢": "she1", "谁": "shei2", "森": "sen1", "僧": "seng1", "杉": "shan1",
    "捏": "nie1", "镍": "nie4", "您": "nin2", "宁": "ning2", "凝": "ning2",
    "牛": "niu2", "浓": "nong2", "挪": "nuo2", "诺": "nuo4", "娘": "niang2",
    "鸟": "niao3", "尿": "niao4", "捻": "nian3", "念": "nian4", "年": "nian2",
    "撵": "nian3", "酿": "niang4", "掐": "qia1", "恰": "qia4", "卡": "qia3",
    "悄": "qiao1", "敲": "qiao1", "桥": "qiao2", "瞧": "qiao2", "巧": "qiao3",
    "翘": "qiao4", "俏": "qiao4", "窍": "qiao4", "茄": "qie2", "钦": "qin1",
    "琼": "qiong2", "穷": "qiong2", "畦": "qi2", "墙": "qiang2",
    "枪": "qiang1", "腔": "qiang1", "抢": "qiang3", "呛": "qiang4",
    "软": "ruan3", "锐": "rui4", "瑞": "rui4", "闰": "run4", "润": "run4",
    "撒": "sa1", "洒": "sa3", "萨": "sa4", "腮": "sai1", "塞": "sai1",
    "嗓": "sang3", "丧": "sang4", "桑": "sang1", "骚": "sao1", "扫": "sao3",
    "嫂": "sao3", "涩": "se4", "煞": "sha1", "傻": "sha3", "厦": "sha4",
    "筛": "shai1", "晒": "shai4", "闪": "shan3", "陕": "shan3",
    "墒": "shang1", "捎": "shao1", "哨": "shao4", "舍": "she3",
    "摔": "shuai1", "甩": "shuai3", "帅": "shuai4", "衰": "shuai1",
    "拴": "shuan1", "双": "shuang1", "爽": "shuang3", "霜": "shuang1",
    "顺": "shun4", "吮": "shun3", "烁": "shuo4", "硕": "shuo4",
    "嵩": "song1", "耸": "song3", "艘": "sou1", "搜": "sou1", "嗽": "sou4",
    "僳": "su4", "狸": "li2", "贸": "mao4", "侧": "ce4", "森": "sen1",
    "飞": "fei1", "玩": "wan2", "咱": "zan2", "暂": "zan4", "赞": "zan4",
    "遭": "zao1", "凿": "zao2", "贼": "zei2", "榨": "zha4", "眨": "zha3",
    "闸": "zha2", "宅": "zhai2", "窄": "zhai3", "掸": "dan3",
    "〇": "ling2",
}

PINYIN_TABLE: Dict[str, str] = {}


def _build() -> None:
    from .pinyin_data2 import _DATA2

    # base table first (its readings win for duplicated chars), then the
    # GB-coverage extension
    for data in (_DATA, _DATA2):
        for line in data.strip().splitlines():
            line = line.strip()
            if not line or ":" not in line:
                continue
            py, chars = line.split(":", 1)
            py = py.strip()
            if not py or not py[-1].isdigit():
                continue
            for ch in chars.strip():
                PINYIN_TABLE.setdefault(ch, py)
    for ch, py in _EXTRA_CHARS.items():
        PINYIN_TABLE.setdefault(ch, py)


_build()


def char_pinyin(ch: str) -> Optional[str]:
    return PINYIN_TABLE.get(ch)


def word_pinyin(word: str) -> Optional[List[str]]:
    """Pinyin for a segmented word, with polyphone overrides."""
    if word in WORD_OVERRIDES:
        return WORD_OVERRIDES[word]
    out = []
    for ch in word:
        py = PINYIN_TABLE.get(ch)
        if py is None:
            return None
        out.append(py)
    return out
